// Fused bidirectional masked LSTM recurrence, forward (inference).
//
// Replaces: aas_enhancement_tpu/ops/pallas/rnn_kernel.py::lstm_scan_tm
// forward (_lstm_tm_fwd_call / _lstm_tm_fwd_kernel).  Same math, cell by cell:
//   g = gx[t] + (h @ wh[d] + bh[d]),  gate order i, f, g, o
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   y[t] = m[t] * h';  (h, c) <- m * (h', c') + (1 - m) * (h, c)
// Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0 over the same
// natural-order gx and mask, so it stays at zero through right padding.  The
// inference forward does not save the pre-update states the VJP needs.
//
// On a TPU the Pallas grid runs in order and carries (h, c) in scratch across
// grid steps.  Blocks on Hopper run in no order, so the whole time loop lives
// inside one block: one block per (direction, tile of kRows batch rows), with
// h, c and the step's gate pre-activations in shared memory.
//
// Bound on the H100: the recurrence is sequential, and each step needs all of
// wh[d] (H x 4H f32 = 1 MiB at H = 256), more than an SM's 227 KB of shared
// memory.  So each step streams wh[d] from L2 into one SM: the kernel is
// bounded by one SM's L2 bandwidth, about 1 MiB per step whatever the batch.
// The design amortizes that read over kRows batch rows (each wh element
// loaded once feeds kRows FMAs), one thread per gate column so the loads are
// coalesced and 32 warps keep many in flight.  Splitting wh across the SMs
// of a cluster (distributed shared memory) is the later step that removes
// the L2 bound.
//
// Layout: gxf/gxb [T, B, 4H] with unit stride in the last dim and strides
// (stride_t, stride_b) in elements (they may be the two halves of one
// [T, B, 8H] tensor); m [T, B]; wh [2, H, 4H]; bh [2, 4H]; yf/yb [T, B, H].
// All f32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;   // batch rows per block

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void lstm_tm_fwd_kernel(const float* __restrict__ gxf,
                                   const float* __restrict__ gxb,
                                   long long stride_t, long long stride_b,
                                   const float* __restrict__ m,
                                   const float* __restrict__ wh,
                                   const float* __restrict__ bh,
                                   float* __restrict__ yf,
                                   float* __restrict__ yb, int T, int B,
                                   int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* h_s = smem;                     // [kRows][H]
  float* c_s = h_s + kRows * H;          // [kRows][H]
  float* g_s = c_s + kRows * H;          // [kRows][G]

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const float* gx = d == 0 ? gxf : gxb;
  float* y = d == 0 ? yf : yb;
  const float* w = wh + (size_t)d * H * G;
  const float* bias = bh + (size_t)d * G;

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) {
    h_s[e] = 0.f;
    c_s[e] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? s : T - 1 - s;

    // Gate pre-activations: one thread per gate column j.
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
#pragma unroll 8
      for (int i = 0; i < H; ++i) {
        const float wv = __ldg(w + (size_t)i * G + j);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          acc[rr] = fmaf(h_s[rr * H + i], wv, acc[rr]);
      }
      const float bj = bias[j];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {   // static indices keep acc in registers
        if (rr < nb) {
          const float gv =
              gx[(size_t)t * stride_t + (size_t)(b0 + rr) * stride_b + j];
          g_s[rr * G + j] = gv + (acc[rr] + bj);
        }
      }
    }
    __syncthreads();

    // Cell update: one thread per (row, hidden unit).
    for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
      const int rr = e / H;
      const int u = e - rr * H;
      const float* g = g_s + rr * G;
      const float c = c_s[e];
      const float h = h_s[e];
      const float c_new = sigmoid(g[H + u] + 1.f) * c
                          + sigmoid(g[u]) * tanhf(g[2 * H + u]);
      const float h_new = sigmoid(g[3 * H + u]) * tanhf(c_new);
      const float mt = m[(size_t)t * B + b0 + rr];
      y[((size_t)t * B + b0 + rr) * H + u] = mt * h_new;
      h_s[e] = mt * h_new + (1.f - mt) * h;
      c_s[e] = mt * c_new + (1.f - mt) * c;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int aas_lstm_tm_fwd(const float* gxf, const float* gxb,
                               long long stride_t, long long stride_b,
                               const float* m, const float* wh, const float* bh,
                               float* yf, float* yb, int T, int B, int H,
                               cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)kRows * 6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_tm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  lstm_tm_fwd_kernel<<<grid, threads, smem, stream>>>(
      gxf, gxb, stride_t, stride_b, m, wh, bh, yf, yb, T, B, H);
  return (int)cudaGetLastError();
}
