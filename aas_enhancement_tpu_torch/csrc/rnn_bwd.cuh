// Shared pieces of the recurrence kernels in lstm_tm.cu and gru_tm.cu: the
// two memory layouts they serve, the float4 FMA, and the transposed recurrent
// product of the streaming backward kernels.
//
// Layouts.  Time-major (lstm_scan_tm, gru_scan_tm): direction d reads its own
// gx tensor [T, B, G] and writes its own y [T, B, H], both in natural time
// order, one mask m [T, B] serves both, and direction 1 walks the time index
// backwards.  Stacked (lstm_scan_pallas and gru_scan_pallas of the TPU
// package: gx [T, 2, B, G], m [T, 2, B], y [T, 2, B, H] with direction 1
// already flipped in time by the caller): both directions walk the time index
// forwards, and a direction is an offset inside one tensor.  The kernels take
// the strides below and one flag, so the same device code reads either
// layout in place; what the training forwards save for the backward
// ([2, T, B, .], indexed by the layout's own time index) is the same for both.
//
// Each backward step needs dh = dg @ wh[d]^T + (carry terms), dg the step's
// [kRows, G] gate gradient (G = 4H for the LSTM, 3H for the GRU).  Two
// routes, chosen by the shape alone (ops/cuda/rnn.py::bwd_resident_cluster):
// the resident backward (rnn_cluster.cuh::res_bwd_kernel) keeps each block's
// gate columns of wh[d] in registers across a cluster and reduce-scatters
// the partial dh through distributed shared memory, bound by its product
// (1536 clocks of FMAs a step for the GRU at H = 512) and the exchange's
// latency; the streaming backward, below, is one block per (direction, kRows
// rows) that reads all of wh[d] again every step, bound by one SM's read of
// it from L2 (33 us a step on the device for the GRU at H = 512, 12.1 for the
// LSTM at H = 256, on an NVIDIA H100 80GB HBM3 at 700 W).  It takes whT
// [2, G, H] (wh transposed once per call by the wrapper), so that a warp's
// threads, each owning four adjacent hidden units, read one row of whT in
// coalesced 16-byte loads.  H / 4 threads cover a row, which would leave most
// of a block idle (64 threads at H = 256), so the G-long sum is split into
// `splits` contiguous ranges, each summed by its own H / 4 threads into a
// partial in shared memory; a second pass adds the partials in order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace aas_rnn {

// The stream type TS of gx, y, the saved state, dy, dgx and dgh: f32, or
// bf16 (the bf16 models, forward and backward).  A bf16 step runs as the
// Pallas kernels do with bf16 streams (rnn_kernel.py, `hc =
// h.astype(wh_ref.dtype)`): gx widened to f32; h, whose state stays f32,
// rounded to bf16 before the recurrent product (dot_in), and wh holding bf16
// values (the host rounds it and passes f32), so each product is exact in
// f32 and the sums are f32; bias, c and the cell math f32; the stored y
// rounded to bf16.  The backward's gate gradient is rounded (dot_in) before
// the dh product and on its store, its carries stay f32.
template <typename TS>
constexpr bool kBf16 = std::is_same<TS, __nv_bfloat16>::value;

__device__ __forceinline__ float ld_stream(const float* p) { return *p; }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_stream(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// h as the recurrent product reads it.
template <typename TS>
__device__ __forceinline__ float dot_in(float h) {
  if constexpr (kBf16<TS>) return __bfloat162float(__float2bfloat16_rn(h));
  return h;
}

struct Layout {
  long long gx_t, gx_b;   // gx strides in elements: time, batch row
  long long m_t, m_d;     // mask strides: time, direction
  long long y_t;          // y and dy stride: time (batch rows are H apart)
  long long dg_t, dg_d;   // dgx strides: time, direction (batch rows are G apart)
  int flip1;              // direction 1 walks the time index backwards
};

// Time-major: gxf/gxb [T, B, G] with strides (gx_t, gx_b), m [T, B],
// y [T, B, H] per direction, dgx [2, T, B, G].  Stacked: gx [T, 2, B, G] (so
// gx_t = 2 B G, gx_b = G), m [T, 2, B], y [T, 2, B, H], dgx [T, 2, B, G],
// contiguous; direction 1's gx, y and dy pointers are the base plus one
// direction's rows.  The backward kernels read no gx: they pass 0 strides.
inline Layout make_layout(int stacked, long long gx_t, long long gx_b, int T,
                          int B, int H, int G) {
  if (stacked)
    return Layout{gx_t, gx_b, 2LL * B, B, 2LL * B * H, 2LL * B * G,
                  (long long)B * G, 0};
  return Layout{gx_t, gx_b, B, 0, (long long)B * H, (long long)B * G,
                (long long)T * B * G, 1};
}

// The time index of step s: forward kernels walk 0..T-1 (direction 1 of the
// time-major layout T-1..0), backward kernels the reverse.
__device__ __forceinline__ int fwd_time(const Layout& L, int d, int s, int T) {
  return d == 1 && L.flip1 ? T - 1 - s : s;
}

__device__ __forceinline__ int bwd_time(const Layout& L, int d, int s, int T) {
  return d == 1 && L.flip1 ? s : T - 1 - s;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

// Ranges the G-long sum is split into: enough to give a 1024-thread block
// one thread per (range, four hidden units), at least four rows per range.
inline int bwd_splits(int G, int H) {
  int s = 1024 / (H / 4);
  if (s > G / 4) s = G / 4;
  return s < 1 ? 1 : s;
}

// Threads of a backward block: one per (range, four hidden units), whole warps.
inline int bwd_threads(int G, int H) {
  int t = ((bwd_splits(G, H) * (H / 4) + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// part_s[sp][rr][k4] = sum over j in range sp of dg_s[rr][j] * whT[j][4k4..4k4+3].
template <int kRows>
__device__ __forceinline__ void dh_partials(const float* __restrict__ dg_s, int G,
                                            const float4* __restrict__ whT4, int H4,
                                            int splits, float4* __restrict__ part_s) {
  const int len = (G + splits - 1) / splits;
  for (int e = threadIdx.x; e < splits * H4; e += blockDim.x) {
    const int sp = e / H4;
    const int k4 = e - sp * H4;
    const int j0 = sp * len;
    const int j1 = min(G, j0 + len);
    float4 acc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float4 w = __ldg(whT4 + (size_t)j * H4 + k4);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) fma4(acc[rr], dg_s[rr * G + j], w);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) part_s[(sp * kRows + rr) * H4 + k4] = acc[rr];
  }
}

// dh_s[rr][u] = (sum of the partials, range by range) + extra_s[rr][u], rr < nb.
template <int kRows>
__device__ __forceinline__ void dh_reduce(const float4* __restrict__ part_s, int splits,
                                          int H, int nb, const float* __restrict__ extra_s,
                                          float* __restrict__ dh_s) {
  const float* part = reinterpret_cast<const float*>(part_s);
  for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[sp * kRows * H + e];
    dh_s[e] = acc + extra_s[e];
  }
}

}  // namespace aas_rnn
