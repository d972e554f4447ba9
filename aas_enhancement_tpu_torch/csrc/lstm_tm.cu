// Fused bidirectional masked LSTM recurrence: forward (inference and
// training) and backward.
//
// Replaces: aas_enhancement_tpu/ops/pallas/rnn_kernel.py::lstm_scan_tm
// forward (_lstm_tm_fwd_call / _lstm_tm_fwd_kernel) and its VJP
// (_lstm_tm_bwd_call :640 / _lstm_tm_bwd_kernel :532).  Same math, cell by cell:
//   g = gx[t] + (h @ wh[d] + bh[d]),  gate order i, f, g, o
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   y[t] = m[t] * h';  (h, c) <- m * (h', c') + (1 - m) * (h, c)
// Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0 over the same
// natural-order gx and mask, so it stays at zero through right padding.
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
// Training forward (kSave): the same kernel also writes, per direction and
// natural time index, the pre-update state h, c ([2, T, B, H] each) and the
// gate activations sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o)
// ([2, T, B, 4H]).  The Pallas VJP saves h and c and recomputes the gates in
// its backward, which would read wh[d] as well as wh[d]^T every step; with
// the activations saved the backward reads only wh[d]^T, as many bytes per
// step as the forward (32 MB more per layer at B = 8, T = 801).
//
// Backward: one block per (direction, kRows rows), walking each direction's
// time in reverse (direction 0 t = T-1..0, direction 1 t = 0..T-1), carrying
// the masked dh and dc in shared memory, as _lstm_tm_bwd_kernel does:
//   dh_upd = m (dh + dy[t]);  dc_upd = m dc
//   do = dh_upd tanh(c') so (1 - so);  dc' = dh_upd so (1 - tanh^2 c') + dc_upd
//   df = dc' c sf (1 - sf);  di = dc' tg si (1 - si);  dg = dc' si (1 - tg^2)
//   dc <- dc' sf + (1 - m) dc;   dh <- [di, df, dg, do] @ wh[d]^T + (1 - m) dh
// It writes dgx [2, T, B, 4H] (the gradient of gxf and gxb); dWh and dbh are
// sums over time of products of that with h, done by the wrapper in
// torch.matmul as the JAX VJP does them outside its kernel.  The transposed
// product is rnn_bwd.cuh's, bound like the forward by one SM's read of
// wh[d]^T (1 MiB) per step.
//
// Layout: gxf/gxb [T, B, 4H] with unit stride in the last dim and strides
// (stride_t, stride_b) in elements (they may be the two halves of one
// [T, B, 8H] tensor); m [T, B]; wh [2, H, 4H]; whT [2, 4H, H]; bh [2, 4H];
// yf/yb/dyf/dyb [T, B, H]; saved and dgx tensors as above.  All f32; the
// backward needs H % 4 == 0 and a 16-byte aligned whT.
//
// The same kernels also replace lstm_scan_pallas (rnn_kernel.py:258, forward
// _lstm_fwd_call :168, VJP _lstm_bwd_call :210), the recurrence on the
// stacked layout gx [T, 2, B, 4H], m [T, 2, B] -> y [T, 2, B, H] whose
// direction 1 the caller has already flipped in time: with `stacked` set the
// entry points pass that layout's strides (rnn_bwd.cuh) and the kernels read
// gx and write y and dgx [T, 2, B, 4H] in place, both directions walking
// t = 0..T-1 (the backward T-1..0).  No copy into the time-major layout.

#include <cuda_runtime.h>

#include "rnn_bwd.cuh"

namespace {

using aas_rnn::sigmoid;

constexpr int kRows = 4;   // batch rows per block

template <bool kSave>
__global__ void lstm_tm_fwd_kernel(const float* __restrict__ gxf,
                                   const float* __restrict__ gxb,
                                   const aas_rnn::Layout L,
                                   const float* __restrict__ m,
                                   const float* __restrict__ wh,
                                   const float* __restrict__ bh,
                                   float* __restrict__ yf,
                                   float* __restrict__ yb,
                                   float* __restrict__ hp,
                                   float* __restrict__ cp,
                                   float* __restrict__ act, int T, int B,
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
  const float* md = m + d * L.m_d;

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) {
    h_s[e] = 0.f;
    c_s[e] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::fwd_time(L, d, s, T);

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
              gx[(size_t)t * L.gx_t + (size_t)(b0 + rr) * L.gx_b + j];
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
      const float si = sigmoid(g[u]);
      const float sf = sigmoid(g[H + u] + 1.f);
      const float tg = tanhf(g[2 * H + u]);
      const float so = sigmoid(g[3 * H + u]);
      const float c_new = sf * c + si * tg;
      const float h_new = so * tanhf(c_new);
      const float mt = md[(size_t)t * L.m_t + b0 + rr];
      y[(size_t)t * L.y_t + (size_t)(b0 + rr) * H + u] = mt * h_new;
      if (kSave) {
        const size_t o = ((size_t)d * T + t) * B + b0 + rr;
        hp[o * H + u] = h;
        cp[o * H + u] = c;
        float* a = act + o * G;
        a[u] = si;
        a[H + u] = sf;
        a[2 * H + u] = tg;
        a[3 * H + u] = so;
      }
      h_s[e] = mt * h_new + (1.f - mt) * h;
      c_s[e] = mt * c_new + (1.f - mt) * c;
    }
    __syncthreads();
  }
}

__global__ void lstm_tm_bwd_kernel(const aas_rnn::Layout L,
                                   const float* __restrict__ m,
                                   const float* __restrict__ whT,
                                   const float* __restrict__ cp,
                                   const float* __restrict__ act,
                                   const float* __restrict__ dyf,
                                   const float* __restrict__ dyb,
                                   float* __restrict__ dgx, int T, int B, int H,
                                   int splits) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  const int H4 = H / 4;
  float4* part_s = smem4;                                      // [splits][kRows][H/4]
  float* dh_s = reinterpret_cast<float*>(part_s + splits * kRows * H4);  // [kRows][H]
  float* dc_s = dh_s + kRows * H;                              // [kRows][H]
  float* keep_s = dc_s + kRows * H;                            // [kRows][H]: (1 - m) dh
  float* dg_s = keep_s + kRows * H;                            // [kRows][G]

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const float* dy = d == 0 ? dyf : dyb;
  const float* md = m + d * L.m_d;
  float* dgx_d = dgx + d * L.dg_d;
  const float4* w4 = reinterpret_cast<const float4*>(whT + (size_t)d * G * H);

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) {
    dh_s[e] = 0.f;
    dc_s[e] = 0.f;
  }
  for (int e = threadIdx.x; e < kRows * G; e += blockDim.x) dg_s[e] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::bwd_time(L, d, s, T);

    // Cell backward: one thread per (row, hidden unit).
    for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
      const int rr = e / H;
      const int u = e - rr * H;
      const size_t o = ((size_t)d * T + t) * B + b0 + rr;
      const float* a = act + o * G;
      const float si = a[u];
      const float sf = a[H + u];
      const float tg = a[2 * H + u];
      const float so = a[3 * H + u];
      const float c = cp[o * H + u];
      const float tc = tanhf(sf * c + si * tg);
      const float mt = md[(size_t)t * L.m_t + b0 + rr];
      const float dh = dh_s[e];
      const float dc = dc_s[e];
      const float dh_upd =
          mt * (dh + dy[(size_t)t * L.y_t + (size_t)(b0 + rr) * H + u]);
      const float dc_new = dh_upd * so * (1.f - tc * tc) + mt * dc;
      const float d_i = dc_new * tg * si * (1.f - si);
      const float d_f = dc_new * c * sf * (1.f - sf);
      const float d_g = dc_new * si * (1.f - tg * tg);
      const float d_o = dh_upd * tc * so * (1.f - so);
      dc_s[e] = dc_new * sf + (1.f - mt) * dc;
      keep_s[e] = (1.f - mt) * dh;
      float* g = dg_s + rr * G;
      float* out = dgx_d + (size_t)t * L.dg_t + (size_t)(b0 + rr) * G;
      g[u] = out[u] = d_i;
      g[H + u] = out[H + u] = d_f;
      g[2 * H + u] = out[2 * H + u] = d_g;
      g[3 * H + u] = out[3 * H + u] = d_o;
    }
    __syncthreads();
    aas_rnn::dh_partials<kRows>(dg_s, G, w4, H4, splits, part_s);
    __syncthreads();
    aas_rnn::dh_reduce<kRows>(part_s, splits, H, nb, keep_s, dh_s);
    __syncthreads();
  }
}

template <bool kSave>
int launch_fwd(const float* gxf, const float* gxb, const aas_rnn::Layout& L,
               const float* m, const float* wh,
               const float* bh, float* yf, float* yb, float* hp, float* cp,
               float* act, int T, int B, int H, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)kRows * 6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_tm_fwd_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  lstm_tm_fwd_kernel<kSave><<<grid, threads, smem, stream>>>(
      gxf, gxb, L, m, wh, bh, yf, yb, hp, cp, act, T, B, H);
  return (int)cudaGetLastError();
}

int launch_bwd(const aas_rnn::Layout& L, const float* m, const float* whT,
               const float* cp, const float* act, const float* dyf,
               const float* dyb, float* dgx, int T, int B, int H,
               cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  if (H % 4) return (int)cudaErrorInvalidValue;
  const int G = 4 * H;
  const int splits = aas_rnn::bwd_splits(G, H);
  const size_t smem = ((size_t)splits * kRows * H + (size_t)kRows * (3 * H + G))
                      * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_tm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  lstm_tm_bwd_kernel<<<grid, aas_rnn::bwd_threads(G, H), smem, stream>>>(
      L, m, whT, cp, act, dyf, dyb, dgx, T, B, H, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry per direction of the pass, both layouts (`stacked` picks the
// strides, aas_rnn::make_layout).  gx0/gx1, y0/y1 and dy0/dy1 are the two
// directions' tensors (time-major) or the two halves of one stacked tensor;
// gx_t, gx_b are gx's strides in elements.  hp, cp and act are NULL for
// inference and the buffers the backward reads for training.
extern "C" int aas_lstm_fwd(const float* gx0, const float* gx1, long long gx_t,
                            long long gx_b, const float* m, const float* wh,
                            const float* bh, float* y0, float* y1, float* hp,
                            float* cp, float* act, int stacked, int T, int B,
                            int H, cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, gx_t, gx_b, T, B, H, 4 * H);
  if (hp == nullptr)
    return launch_fwd<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr,
                             nullptr, T, B, H, stream);
  return launch_fwd<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, cp, act, T, B, H,
                          stream);
}

// dgx is [2, T, B, 4H] (time-major) or [T, 2, B, 4H] (stacked).
extern "C" int aas_lstm_bwd(const float* m, const float* whT, const float* cp,
                            const float* act, const float* dy0, const float* dy1,
                            float* dgx, int stacked, int T, int B, int H,
                            cudaStream_t stream) {
  return launch_bwd(aas_rnn::make_layout(stacked, 0, 0, T, B, H, 4 * H), m, whT,
                    cp, act, dy0, dy1, dgx, T, B, H, stream);
}
