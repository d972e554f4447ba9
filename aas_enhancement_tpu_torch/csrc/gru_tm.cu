// Fused bidirectional masked GRU recurrence, forward (inference).
//
// Replaces: aas_enhancement_tpu/ops/pallas/rnn_kernel.py::gru_scan_tm (:892)
// forward (_gru_tm_fwd_call :817, body _gru_tm_fwd_kernel :724).  Same math,
// cell by cell, gate order r, z, n:
//   gh = h @ wh[d] + bh[d]
//   r = sigmoid(xr + ghr);  z = sigmoid(xz + ghz);  n = tanh(xn + r * ghn)
//   h' = (1 - z) * n + z * h;  y[t] = m[t] * h';  h <- m * h' + (1 - m) * h
// The n-slice of bh sits inside the r product, so it is added to gh here and
// never folded into gx (which carries the wx bias, outside the product).
// Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0 over the same
// natural-order gx and mask, so it stays at zero through right padding.  The
// inference forward does not save the pre-update states the VJP needs.
//
// As in lstm_tm.cu, the Pallas grid's sequential carry becomes a time loop
// inside one block per (direction, tile of kRows batch rows), with h and the
// step's recurrent product gh in shared memory (kRows * 4H floats, 32 KB at
// H = 512).
//
// Bound on the H100: each step needs all of wh[d] (H x 3H f32 = 3 MiB at
// H = 512), far more than an SM's 227 KB of shared memory, so each step
// streams it from L2 into one SM: the kernel is bounded by one SM's L2
// bandwidth, 3 MiB per step whatever the batch, with kRows * H * 3H FMAs per
// step (14 us of one SM's FP32 issue at H = 512, kRows = 4) overlapping it.
// Each thread owns four adjacent gate columns, so wh arrives in 16-byte loads
// (coalesced across the warp), four rows of wh are in flight per iteration,
// and each loaded element feeds kRows FMAs; h comes from shared memory as
// float4 broadcasts.  The redesign for this card (ROADMAP queue B) splits
// wh[d]'s hidden units across a 16-block cluster so that each SM keeps its
// 192 KB slice in shared memory and h is exchanged through distributed
// shared memory, one cluster barrier per step: wh is then read from L2 once.
//
// Layout: gxf/gxb [T, B, 3H] with unit stride in the last dim and strides
// (stride_t, stride_b) in elements (they may be the two halves of one
// [T, B, 6H] tensor); m [T, B]; wh [2, H, 3H] and bh [2, 3H], contiguous and
// 16-byte aligned; yf/yb [T, B, H].  All f32; H % 4 == 0.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;   // batch rows per block

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

__global__ void gru_tm_fwd_kernel(const float* __restrict__ gxf,
                                  const float* __restrict__ gxb,
                                  long long stride_t, long long stride_b,
                                  const float* __restrict__ m,
                                  const float* __restrict__ wh,
                                  const float* __restrict__ bh,
                                  float* __restrict__ yf,
                                  float* __restrict__ yb, int T, int B,
                                  int H) {
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  const int G4 = G / 4;
  const int H4 = H / 4;
  float* h_s = reinterpret_cast<float*>(smem4);   // [kRows][H]
  float* g_s = h_s + kRows * H;                   // [kRows][G]: h @ wh[d] + bh[d]
  const float4* h4 = reinterpret_cast<const float4*>(h_s);

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const float* gx = d == 0 ? gxf : gxb;
  float* y = d == 0 ? yf : yb;
  const float4* w4 = reinterpret_cast<const float4*>(wh + (size_t)d * H * G);
  const float4* b4 = reinterpret_cast<const float4*>(bh + (size_t)d * G);

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) h_s[e] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? s : T - 1 - s;

    // Recurrent product: one thread per four gate columns 4*j4 .. 4*j4+3,
    // summed over the hidden index in order.
    for (int j4 = threadIdx.x; j4 < G4; j4 += blockDim.x) {
      float4 acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int i4 = 0; i4 < H4; ++i4) {
        float4 wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = __ldg(w4 + (size_t)(4 * i4 + k) * G4 + j4);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {   // static indices keep acc in registers
          const float4 hv = h4[rr * H4 + i4];
          fma4(acc[rr], hv.x, wv[0]);
          fma4(acc[rr], hv.y, wv[1]);
          fma4(acc[rr], hv.z, wv[2]);
          fma4(acc[rr], hv.w, wv[3]);
        }
      }
      const float4 bj = __ldg(b4 + j4);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (rr < nb) {
          reinterpret_cast<float4*>(g_s + rr * G)[j4] =
              make_float4(acc[rr].x + bj.x, acc[rr].y + bj.y, acc[rr].z + bj.z,
                          acc[rr].w + bj.w);
        }
      }
    }
    __syncthreads();

    // Cell update: one thread per (row, hidden unit).
    for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
      const int rr = e / H;
      const int u = e - rr * H;
      const float* x = gx + (size_t)t * stride_t + (size_t)(b0 + rr) * stride_b;
      const float* g = g_s + rr * G;
      const float r = sigmoid(x[u] + g[u]);
      const float z = sigmoid(x[H + u] + g[H + u]);
      const float n = tanhf(x[2 * H + u] + r * g[2 * H + u]);
      const float h = h_s[e];
      const float h_new = (1.f - z) * n + z * h;
      const float mt = m[(size_t)t * B + b0 + rr];
      y[((size_t)t * B + b0 + rr) * H + u] = mt * h_new;
      h_s[e] = mt * h_new + (1.f - mt) * h;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int aas_gru_tm_fwd(const float* gxf, const float* gxb,
                              long long stride_t, long long stride_b,
                              const float* m, const float* wh, const float* bh,
                              float* yf, float* yb, int T, int B, int H,
                              cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  if (H % 4) return (int)cudaErrorInvalidValue;
  int threads = ((3 * H / 4 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)kRows * 4 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_tm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  gru_tm_fwd_kernel<<<grid, threads, smem, stream>>>(
      gxf, gxb, stride_t, stride_b, m, wh, bh, yf, yb, T, B, H);
  return (int)cudaGetLastError();
}
