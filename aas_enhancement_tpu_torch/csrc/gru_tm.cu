// Fused bidirectional masked GRU recurrence: forward (inference and
// training) and backward.
//
// Replaces: aas_enhancement_tpu/ops/pallas/rnn_kernel.py::gru_scan_tm (:892)
// forward (_gru_tm_fwd_call :817, body _gru_tm_fwd_kernel :724) and its VJP
// (_gru_tm_bwd_call :846, body _gru_tm_bwd_kernel :761).  Same math, cell by
// cell, gate order r, z, n:
//   gh = h @ wh[d] + bh[d]
//   r = sigmoid(xr + ghr);  z = sigmoid(xz + ghz);  n = tanh(xn + r * ghn)
//   h' = (1 - z) * n + z * h;  y[t] = m[t] * h';  h <- m * h' + (1 - m) * h
// The n-slice of bh sits inside the r product, so it is added to gh here and
// never folded into gx (which carries the wx bias, outside the product).
// Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0 over the same
// natural-order gx and mask, so it stays at zero through right padding.
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
// Training forward (kSave): the same kernel also writes, per direction and
// natural time index, the pre-update state h ([2, T, B, H]) and r, z, n and
// ghn = (h @ wh[d] + bh[d])_n ([2, T, B, 4H]).  The Pallas VJP saves h alone
// and recomputes gh in its backward, which would read wh[d] as well as
// wh[d]^T every step; with the gates saved the backward reads only wh[d]^T,
// as many bytes per step as the forward (52 MB more per layer at B = 8,
// T = 401, H = 512).
//
// Backward: one block per (direction, kRows rows), walking each direction's
// time in reverse (direction 0 t = T-1..0, direction 1 t = 0..T-1), carrying
// the masked dh in shared memory, as _gru_tm_bwd_kernel does:
//   dh_upd = m (dh + dy[t]);  dz = dh_upd (h - n) z (1 - z)
//   dn = dh_upd (1 - z) (1 - n^2);  dr = dn ghn r (1 - r)
//   dgx = [dr, dz, dn];  dgh = [dr, dz, dn * r]
//   dh <- dgh @ wh[d]^T + dh_upd z + (1 - m) dh
// It writes dgx [2, T, B, 3H] (the gradient of gxf and gxb) and, when the
// caller wants dWh or dbh (a trained GRU; not the frozen AM), dgh
// [2, T, B, 3H]; the wrapper sums those into dWh and dbh with torch.matmul,
// as the JAX VJP does outside its kernel.  The transposed product is
// rnn_bwd.cuh's, bound like the forward by one SM's read of wh[d]^T (3 MiB)
// per step.
//
// Layout: gxf/gxb [T, B, 3H] with unit stride in the last dim and strides
// (stride_t, stride_b) in elements (they may be the two halves of one
// [T, B, 6H] tensor); m [T, B]; wh [2, H, 3H], whT [2, 3H, H] and bh [2, 3H],
// contiguous and 16-byte aligned; yf/yb/dyf/dyb [T, B, H].  All f32;
// H % 4 == 0.
//
// The same kernels also replace gru_scan_pallas (rnn_kernel.py:452, forward
// _gru_fwd_call :370, VJP _gru_bwd_call :406), the recurrence on the stacked
// layout gx [T, 2, B, 3H], m [T, 2, B] -> y [T, 2, B, H] whose direction 1
// the caller has already flipped in time: with `stacked` set the entry points
// pass that layout's strides (rnn_bwd.cuh) and the kernels read gx and write
// y and dgx [T, 2, B, 3H] in place, both directions walking t = 0..T-1 (the
// backward T-1..0).  dgh keeps its [2, T, B, 3H] layout beside the saved h.

#include <cuda_runtime.h>

#include "rnn_bwd.cuh"

namespace {

using aas_rnn::fma4;
using aas_rnn::sigmoid;

constexpr int kRows = 4;   // batch rows per block

template <bool kSave>
__global__ void gru_tm_fwd_kernel(const float* __restrict__ gxf,
                                  const float* __restrict__ gxb,
                                  const aas_rnn::Layout L,
                                  const float* __restrict__ m,
                                  const float* __restrict__ wh,
                                  const float* __restrict__ bh,
                                  float* __restrict__ yf,
                                  float* __restrict__ yb,
                                  float* __restrict__ hp,
                                  float* __restrict__ act, int T, int B,
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
  const float* md = m + d * L.m_d;

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) h_s[e] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::fwd_time(L, d, s, T);

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
      const float* x = gx + (size_t)t * L.gx_t + (size_t)(b0 + rr) * L.gx_b;
      const float* g = g_s + rr * G;
      const float r = sigmoid(x[u] + g[u]);
      const float z = sigmoid(x[H + u] + g[H + u]);
      const float n = tanhf(x[2 * H + u] + r * g[2 * H + u]);
      const float h = h_s[e];
      const float h_new = (1.f - z) * n + z * h;
      const float mt = md[(size_t)t * L.m_t + b0 + rr];
      y[(size_t)t * L.y_t + (size_t)(b0 + rr) * H + u] = mt * h_new;
      if (kSave) {
        const size_t o = ((size_t)d * T + t) * B + b0 + rr;
        hp[o * H + u] = h;
        float* a = act + o * 4 * H;
        a[u] = r;
        a[H + u] = z;
        a[2 * H + u] = n;
        a[3 * H + u] = g[2 * H + u];
      }
      h_s[e] = mt * h_new + (1.f - mt) * h;
    }
    __syncthreads();
  }
}

__global__ void gru_tm_bwd_kernel(const aas_rnn::Layout L,
                                  const float* __restrict__ m,
                                  const float* __restrict__ whT,
                                  const float* __restrict__ hp,
                                  const float* __restrict__ act,
                                  const float* __restrict__ dyf,
                                  const float* __restrict__ dyb,
                                  float* __restrict__ dgx,
                                  float* __restrict__ dgh, int T, int B, int H,
                                  int splits) {
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  const int H4 = H / 4;
  float4* part_s = smem4;                                      // [splits][kRows][H/4]
  float* dh_s = reinterpret_cast<float*>(part_s + splits * kRows * H4);  // [kRows][H]
  float* keep_s = dh_s + kRows * H;             // [kRows][H]: dh_upd z + (1 - m) dh
  float* dg_s = keep_s + kRows * H;             // [kRows][G]: dgh

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const float* dy = d == 0 ? dyf : dyb;
  const float* md = m + d * L.m_d;
  float* dgx_d = dgx + d * L.dg_d;
  const float4* w4 = reinterpret_cast<const float4*>(whT + (size_t)d * G * H);

  for (int e = threadIdx.x; e < kRows * H; e += blockDim.x) dh_s[e] = 0.f;
  for (int e = threadIdx.x; e < kRows * G; e += blockDim.x) dg_s[e] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::bwd_time(L, d, s, T);

    // Cell backward: one thread per (row, hidden unit).
    for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
      const int rr = e / H;
      const int u = e - rr * H;
      const size_t o = ((size_t)d * T + t) * B + b0 + rr;
      const float* a = act + o * 4 * H;
      const float r = a[u];
      const float z = a[H + u];
      const float n = a[2 * H + u];
      const float ghn = a[3 * H + u];
      const float h = hp[o * H + u];
      const float mt = md[(size_t)t * L.m_t + b0 + rr];
      const float dh = dh_s[e];
      const float dh_upd =
          mt * (dh + dy[(size_t)t * L.y_t + (size_t)(b0 + rr) * H + u]);
      const float d_z = dh_upd * (h - n) * z * (1.f - z);
      const float d_n = dh_upd * (1.f - z) * (1.f - n * n);
      const float d_r = d_n * ghn * r * (1.f - r);
      const float d_hn = d_n * r;
      keep_s[e] = dh_upd * z + (1.f - mt) * dh;
      float* g = dg_s + rr * G;
      g[u] = d_r;
      g[H + u] = d_z;
      g[2 * H + u] = d_hn;
      float* out = dgx_d + (size_t)t * L.dg_t + (size_t)(b0 + rr) * G;
      out[u] = d_r;
      out[H + u] = d_z;
      out[2 * H + u] = d_n;
      if (dgh != nullptr) {
        float* oh = dgh + o * G;
        oh[u] = d_r;
        oh[H + u] = d_z;
        oh[2 * H + u] = d_hn;
      }
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
               const float* bh, float* yf, float* yb, float* hp, float* act,
               int T, int B, int H, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  if (H % 4) return (int)cudaErrorInvalidValue;
  int threads = ((3 * H / 4 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)kRows * 4 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_tm_fwd_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  gru_tm_fwd_kernel<kSave><<<grid, threads, smem, stream>>>(
      gxf, gxb, L, m, wh, bh, yf, yb, hp, act, T, B, H);
  return (int)cudaGetLastError();
}

int launch_bwd(const aas_rnn::Layout& L, const float* m, const float* whT,
               const float* hp, const float* act, const float* dyf,
               const float* dyb, float* dgx, float* dgh, int T, int B, int H,
               cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  if (H % 4) return (int)cudaErrorInvalidValue;
  const int G = 3 * H;
  const int splits = aas_rnn::bwd_splits(G, H);
  const size_t smem = ((size_t)splits * kRows * H + (size_t)kRows * (2 * H + G))
                      * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_tm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kRows - 1) / kRows, 2);
  gru_tm_bwd_kernel<<<grid, aas_rnn::bwd_threads(G, H), smem, stream>>>(
      L, m, whT, hp, act, dyf, dyb, dgx, dgh, T, B, H, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry per direction of the pass, both layouts (`stacked` picks the
// strides, aas_rnn::make_layout).  gx0/gx1, y0/y1 and dy0/dy1 are the two
// directions' tensors (time-major) or the two halves of one stacked tensor;
// gx_t, gx_b are gx's strides in elements.  hp and act are NULL for inference
// and the buffers the backward reads for training.
extern "C" int aas_gru_fwd(const float* gx0, const float* gx1, long long gx_t,
                           long long gx_b, const float* m, const float* wh,
                           const float* bh, float* y0, float* y1, float* hp,
                           float* act, int stacked, int T, int B, int H,
                           cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, gx_t, gx_b, T, B, H, 3 * H);
  if (hp == nullptr)
    return launch_fwd<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr, T,
                             B, H, stream);
  return launch_fwd<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, act, T, B, H, stream);
}

// dgx is [2, T, B, 3H] (time-major) or [T, 2, B, 3H] (stacked); dgh
// [2, T, B, 3H] in both, or NULL when no weight gradient is wanted.
extern "C" int aas_gru_bwd(const float* m, const float* whT, const float* hp,
                           const float* act, const float* dy0, const float* dy1,
                           float* dgx, float* dgh, int stacked, int T, int B,
                           int H, cudaStream_t stream) {
  return launch_bwd(aas_rnn::make_layout(stacked, 0, 0, T, B, H, 3 * H), m, whT,
                    hp, act, dy0, dy1, dgx, dgh, T, B, H, stream);
}
