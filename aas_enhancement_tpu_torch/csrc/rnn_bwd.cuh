// Shared pieces of the recurrence kernels in lstm_tm.cu and gru_tm.cu: the
// float4 FMA, and the transposed recurrent product of the backward kernels.
//
// Each backward step needs dh = dg @ wh[d]^T + (carry terms): dg is the
// step's [kRows, G] gate gradient (G = 4H for the LSTM, 3H for the GRU) in
// shared memory, and the product reads all of wh[d] again, as the forward
// does.  The kernels take whT [2, G, H] (wh transposed once per call by the
// wrapper), so that a warp's threads, each owning four adjacent hidden units,
// read one row of whT in coalesced 16-byte loads: the same access pattern as
// the forward's reads of wh.  H / 4 threads cover a row, which would leave
// most of a block idle (64 threads at H = 256), so the G-long sum is split
// into `splits` contiguous ranges, each summed by its own H / 4 threads into
// a partial in shared memory; a second pass adds the partials in order.

#pragma once

#include <cuda_runtime.h>

namespace aas_rnn {

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
