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
// inside the kernel, one (direction, tile of kRows batch rows) per block or
// per cluster of blocks.
//
// Bound on the H100: the recurrence is T dependent steps, and each step needs
// all of wh[d] (H x 3H f32 = 3 MiB at H = 512), far more than one SM's 227 KB
// of shared memory.  Two forward kernels, chosen by the shape alone
// (ops/cuda/rnn.py::gru_resident_cluster):
//
// Resident (gru_res_fwd_kernel), where a cluster of C <= 16 blocks can hold
// wh[d] (16 is above the portable cluster size of 8: the launcher allows the
// kernel the non-portable size and asks the occupancy calculator, once per
// shape, whether the card can schedule such a cluster at all): block k of the
// cluster owns the hidden units [k U, (k + 1) U), U = H / C <= 32 and even,
// and the 3 U gate columns r, z, n of those units, so r, z and
// (W_hn h + b_hn) of a unit meet in one block and the cell update needs no
// exchange.  The block loads its H x 3U slice of wh[d] into shared memory
// once per call: 192 KB at H = 512, C = 16, which fits only with three floats
// per (input, unit); the LSTM's float4 record padded to (r, z, n, 0) would be
// 256 KB.  Slice layout: packed 12-byte records (r, z, n), four of them (a
// lane's inputs kl, kl + 16, kl + 32, kl + 48 of a group of 64 inputs) side
// by side, so a lane reads its 48 bytes of a group as three float4 loads at a
// lane stride of 48 bytes.  A 16-byte load is served a quarter warp at a
// time, and eight lanes 48 bytes apart start at the banks 0, 12, 24, 4, 16,
// 28, 8, 20, four banks each: all 32 banks once, no conflict, and 0.75 load
// instructions per input where three planes of floats would need 3 (equally
// free of conflicts, four times the instructions).  H is padded to whole
// groups of 64 inputs with zero weights.  As in the LSTM's resident kernel a
// warp serves two units and a unit's 16 lanes split its inputs; for each
// input a lane reads one float4 of h, the tile's four rows (the warp's two
// units read the same 16: a broadcast), for 12 FMAs into its 4 rows x 3 gates
// sums, kept in slots of four whose fourth stays zero.  Where the slice has
// at least kRegGroups groups (H > 320) the weights of a lane's first
// kRegGroups groups also stay in registers, three quarters of the slice at
// H = 512: the sweep is bound by shared-memory loads (slice and h), not by
// FMAs, and every group moved into registers took about 0.05 us off a step;
// 6 groups are what 128 registers a thread hold (the training variant
// spills one value).  Four levels of shuffles then add the 16
// lanes' sums and scatter them (aas_rnn::scatter_add, skipping the zero
// slots), so that lane (row, gate) ends with that one total, always added in
// the same order: no pass through shared memory, no block-wide barrier in the
// loop.  The cell: every lane adds its bias and takes sigmoid(x + gh) (used
// from the r and z lanes); one round of shuffles hands r, z, ghn and xn to
// the four lanes of a (unit, row), which all compute n = tanh(xn + r ghn)
// and the same new h in registers: two transcendentals in sequence, as the
// LSTM's tanh(c').  The fourth lane of a cell, whose sum slot is spare,
// carries the training variant's fourth store (ghn).  The unit's new h of the
// four rows then goes as one 16-byte st.async store into the next-h buffer
// of every block of the cluster, lane i of the unit's 16 to block i (all 16
// lanes send at C = 16), each store reporting its bytes to an mbarrier of the
// receiving block: a block starts step s when its barrier has counted the
// 16 H bytes of h[s].  No cluster-wide barrier in the loop; h is
// double-buffered, which alone keeps a fast block off a slow one's data (to
// send h[s + 2] a block needs every warp's part of h[s + 1], sent after that
// warp's last read of h[s]); the last step sends nothing, so a block may exit
// when its loop ends; gx and the mask are fetched a step ahead, after the
// sends; a padded row of a tile (B % 4 != 0) has gx = 0, m = 0 and stores
// nothing.  Clusters do not depend on each other: more tiles than the card
// holds clusters (B = 32: 16 clusters of 16 blocks) run in waves.
//
// What bounds a step (NVIDIA H100 80GB HBM3, 700.00 W, SM clock 1980 MHz,
// T = 401, B = 4, H = 512: 2.5 us a step, 1.02 ms a call on the device alone
// and 1.06 between two events around the wrapper, where the streaming kernel
// takes 43 us and 17.7 ms): the sweep (196,608 FMAs = 1536 clocks of the
// SM's FMA rate beside about 1400 clocks of shared-memory loads, 1024 of
// them h: every warp reads all of h for its two units), then the same chain
// of latencies as in the LSTM's kernel: four shuffle levels, expf and a
// division, a round of shuffles, tanhf, four more shuffles, the store's hop
// to 15 other SMs and the waiting warps' poll of the mbarrier.  The card runs
// 7 clusters of 16 at once, so B = 8 (4 clusters) takes B = 4's time and
// B = 32 (16 clusters: waves of 7, 7 and 2) three times as long.
//
// Streaming (gru_tm_fwd_kernel), for the shapes no cluster of <= 16 blocks of
// <= 32 units holds (H = 1024, an odd U) and as the measurement's other
// side: one block per (direction, kRows rows) keeps h and the step's
// recurrent product gh in shared memory (kRows * 4H floats, 32 KB at
// H = 512) and streams wh[d] from L2 every step, bounded by one SM's L2
// bandwidth, 3 MiB per step whatever the batch (43 us a step at H = 512),
// with kRows * H * 3H FMAs per step (14 us at one SM's FP32 rate)
// overlapping it.  Each thread owns four adjacent gate columns, so wh arrives
// in 16-byte loads (coalesced across the warp), four rows of wh are in flight
// per iteration, and each loaded element feeds kRows FMAs; h comes from
// shared memory as float4 broadcasts.
//
// Training forward (kSave): either forward kernel also writes, per direction and
// natural time index, the pre-update state h ([2, T, B, H]) and r, z, n and
// ghn = (h @ wh[d] + bh[d])_n ([2, T, B, 4H]).  The Pallas VJP saves h alone
// and recomputes gh in its backward, which would need the forward's product
// again every step; with the gates saved the backward's only product is the
// transposed one (52 MB more per layer at B = 8, T = 401, H = 512).
//
// Backward, as _gru_tm_bwd_kernel, walking each direction's time in reverse
// (direction 0 t = T-1..0, direction 1 t = 0..T-1) and carrying dh:
//   dh_upd = m (dh + dy[t]);  dz = dh_upd (h - n) z (1 - z)
//   dn = dh_upd (1 - z) (1 - n^2);  dr = dn ghn r (1 - r)
//   dgx = [dr, dz, dn];  dgh = [dr, dz, dn * r]
//   dh <- dgh @ wh[d]^T + dh_upd z + (1 - m) dh
// It writes dgx [2, T, B, 3H] (the gradient of gxf and gxb) and, when the
// caller wants dWh or dbh (a trained GRU; not the frozen AM), dgh
// [2, T, B, 3H]; the wrapper sums those into dWh and dbh with torch.matmul,
// as the JAX VJP does outside its kernel.  Two kernels, chosen by the shape
// alone (ops/cuda/rnn.py::bwd_resident_cluster: the forward's route):
//
// Resident (rnn_cluster.cuh::res_bwd_kernel<GruBwdCell>), wherever the
// resident forward runs: the forward's cluster and ownership (block k owns
// 32 units and their r, z, n columns of wh[d]), but the slice in registers,
// 2 inputs of dh x 96 columns = 192 floats in each of 256 threads at
// H = 512; each block sends every other block its part of dh (a
// reduce-scatter through distributed shared memory, 16 H bytes a step into
// each block, as the forward's broadcast of h).  Bound by the product
// (196,608 FMAs a block and step at H = 512) and the exchange's latency:
// 2.36 us a step, 0.94 ms at T = 401, B = 8 on the device, on an NVIDIA H100
// 80GB HBM3 (700 W).  One input of dh a thread in 512 threads (96 weights,
// 128 registers) was slower: 1.12 against 0.93 ms on full rows.
//
// Streaming (gru_tm_bwd_kernel), for H = 1024 and as the measurement's other
// side (route 0): one block per (direction, kRows rows) keeps dh and dgh in
// shared memory and streams whT [2, 3H, H] (transposed once per call by the
// wrapper) through rnn_bwd.cuh's product: bound like the streaming forward by
// one SM's read of wh[d]^T (3 MiB) per step: 33 us a step on the device at
// H = 512 (13.4 ms at T = 401, B = 8) on an NVIDIA H100 80GB HBM3 (700 W).
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rnn_bwd.cuh"
#include "rnn_cluster.cuh"

namespace {

namespace cg = cooperative_groups;

using aas_rnn::fma4;
using aas_rnn::kWarp;
using aas_rnn::map_to_rank;
using aas_rnn::mbar_expect;
using aas_rnn::mbar_init;
using aas_rnn::mbar_wait;
using aas_rnn::refused;
using aas_rnn::scatter_add;
using aas_rnn::sigmoid;
using aas_rnn::smem_addr;
using aas_rnn::st_async4;

constexpr int kRows = 4;            // batch rows per block (streaming) or cluster (resident)
constexpr int kResUnits = 32;       // most hidden units of a resident block: two per warp
constexpr int kResCluster = 16;     // most blocks of a resident cluster
constexpr int kRegGroups = 6;       // groups of the slice a lane also keeps in registers

// The resident kernel's shared memory in bytes: the slice (H padded to whole
// groups of 64 inputs, 12 bytes per input and unit), h of the four rows twice
// (16 bytes per input), two mbarriers.  The route function of
// ops/cuda/rnn.py repeats it to pick the cluster size.
inline int res_groups(int H) { return (H + 63) / 64; }

inline size_t res_smem(int H, int U) {
  const size_t Hp = 64 * (size_t)res_groups(H);
  return 12 * (size_t)U * Hp + 2 * 16 * Hp + 16;
}

// val[row][gate] += h[row] * (wr, wz, wn)[gate]; slot 3 of a row stays zero.
__device__ __forceinline__ void fma_rows3(float (&val)[16], const float4& hv, float wr,
                                          float wz, float wn) {
  const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    val[4 * rr] = fmaf(hr[rr], wr, val[4 * rr]);
    val[4 * rr + 1] = fmaf(hr[rr], wz, val[4 * rr + 1]);
    val[4 * rr + 2] = fmaf(hr[rr], wn, val[4 * rr + 2]);
  }
}

// A lane's four inputs of one group of 64 (hc[0], hc[16], hc[32], hc[48]: h
// of the four rows) against their packed records (r, z, n) x 4 in a, b, c.
__device__ __forceinline__ void fma_group(float (&val)[16], const float4* hc,
                                          const float4& a, const float4& b,
                                          const float4& c) {
  fma_rows3(val, hc[0], a.x, a.y, a.z);
  fma_rows3(val, hc[16], a.w, b.x, b.y);
  fma_rows3(val, hc[32], b.z, b.w, c.x);
  fma_rows3(val, hc[48], c.y, c.z, c.w);
}

template <bool kSave>
__global__ void __launch_bounds__(kResUnits * 16, 1)
gru_res_fwd_kernel(const float* __restrict__ gxf, const float* __restrict__ gxb,
                   const aas_rnn::Layout L, const float* __restrict__ m,
                   const float* __restrict__ wh, const float* __restrict__ bh,
                   float* __restrict__ yf, float* __restrict__ yb,
                   float* __restrict__ hp, float* __restrict__ act, int T, int B,
                   int H, int U) {
  static_assert(kRows == 4, "a lane's sums are 4 rows x (3 gates and a spare slot)");
  extern __shared__ float4 res_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();       // H / U
  const int rank = (int)cluster.block_rank();
  const int J = (H + 63) / 64;                   // groups of 64 inputs, four per lane of a unit
  const int Hp = 64 * J;
  float4* w_s = res_smem4;                       // [U / 2][J][32 lanes][4 inputs][r, z, n]
  float4* h_s = w_s + (size_t)U * Hp * 3 / 4;    // [2][Hp]: h of the four rows, double-buffered
  // bar[p] counts the bytes arriving in h buffer p (16 H a step).
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(h_s + 2 * Hp);

  const int G = 3 * H;
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * kRows;
  const int nb = min(kRows, B - b0);
  const float* gx = d == 0 ? gxf : gxb;
  float* y = d == 0 ? yf : yb;
  const float* md = m + d * L.m_d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // A unit's 16 lanes split its inputs; after the reduction each holds one
  // (row, gate) sum of the unit and takes part in that row's cell update.
  const int uu = lane >> 4;                      // which of the warp's two units
  const int kl = lane & 15;
  const int row = (lane >> 2) & 3;
  const int gate = lane & 3;                     // r, z, n; 3: the spare lane of a cell
  const int col = rank * U + 2 * warp + uu;      // hidden unit
  const bool valid = row < nb;

  // This block's slice of wh[d], once per call; inputs past H are zero.
  {
    const float* w = wh + (size_t)d * H * G + rank * U;
    float* w_f = reinterpret_cast<float*>(w_s);
    const int n = Hp * 3 * U;
    for (int e = tid; e < n; e += blockDim.x) {
      const int eu = e % U;
      const int g = (e / U) % 3;
      const int k = e / (3 * U);
      const int chunk = k >> 4;                  // 16 inputs, one per lane of the unit
      const size_t rec = (((size_t)(eu >> 1) * J + (chunk >> 2)) * 32 + (eu & 1) * 16 + (k & 15))
                         * 4 + (chunk & 3);
      w_f[rec * 3 + g] = k < H ? w[(size_t)k * G + g * H + eu] : 0.f;
    }
    for (int e = tid; e < 2 * Hp; e += blockDim.x)
      h_s[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid == 0) {     // buffer 1 receives h[1], buffer 0 (now zero: h[0]) h[2]
      mbar_init(bar);
      mbar_init(bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(bar, 16 * H);
      mbar_expect(bar + 1, 16 * H);
    }
  }

  const float bias = gate < 3 ? bh[(size_t)d * G + gate * H + col] : 0.f;
  float h = 0.f;                                 // the same in a cell's four lanes
  float gx_next = 0.f, m_next = 0.f;
  auto fetch = [&](int t) {     // this lane's gx and the mask of time index t, for a real row
    if (valid) {
      if (gate < 3)
        gx_next = gx[(size_t)t * L.gx_t + (size_t)(b0 + row) * L.gx_b + gate * H + col];
      m_next = md[(size_t)t * L.m_t + b0 + row];
    }
  };
  fetch(aas_rnn::fwd_time(L, d, 0, T));
  const float4* wl = w_s + ((size_t)warp * J * 32 + lane) * 3;    // a group is 96 float4 on

  __syncthreads();
  cluster.sync();       // every block's buffers and mbarriers are ready before any send

  // Where the slice has that many, a lane keeps its weights of the first
  // kRegGroups groups in registers: the sweep is bound by shared-memory
  // loads, and these are three quarters of the slice's at H = 512.
  const bool in_regs = J >= kRegGroups;
  float4 wreg[kRegGroups][3];
#pragma unroll
  for (int j = 0; j < kRegGroups; ++j)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      wreg[j][q] = in_regs ? wl[96 * j + q] : make_float4(0.f, 0.f, 0.f, 0.f);

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::fwd_time(L, d, s, T);

    // h[s] has arrived in buffer p: the phase (s - 1) / 2 of its mbarrier is
    // complete.  Thread 0 then arms the barrier for h[s + 2].
    if (s > 0) {
      mbar_wait(bar + p, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < T) mbar_expect(bar + p, 16 * H);
    }

    // This lane's inputs (kl, kl + 16, ...) into the unit's 12 sums.
    float val[16];          // [row][r, z, n, spare]
#pragma unroll
    for (int v = 0; v < 16; ++v) val[v] = 0.f;
    const float4* hc = h_s + p * Hp + kl;
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < kRegGroups; ++j)
        fma_group(val, hc + 64 * j, wreg[j][0], wreg[j][1], wreg[j][2]);
    }
#pragma unroll 2
    for (int j = in_regs ? kRegGroups : 0; j < J; ++j)
      fma_group(val, hc + 64 * j, wl[96 * j], wl[96 * j + 1], wl[96 * j + 2]);
    // Add over the unit's lanes and scatter, so that lane v of the 16 ends
    // with sum v, always added in the same order.
    scatter_add<8, true>(val, lane);
    scatter_add<4, true>(val, lane);
    scatter_add<2, true>(val, lane);
    scatter_add<1, true>(val, lane);

    // gh of this lane's gate; sigmoid(x + gh) is r in a cell's lane 0 and z
    // in its lane 1.  The cell's four lanes then share r, z, ghn and xn and
    // compute the same n and the same new h.
    const float gh = val[0] + bias;
    const float a = sigmoid(gx_next + gh);
    const int cell0 = lane & ~3;
    const float sr = __shfl_sync(kWarp, a, cell0);
    const float sz = __shfl_sync(kWarp, a, cell0 + 1);
    const float ghn = __shfl_sync(kWarp, gh, cell0 + 2);
    const float xn = __shfl_sync(kWarp, gx_next, cell0 + 2);
    const float tn = tanhf(xn + sr * ghn);
    const float mt = m_next;
    const float h_new = (1.f - sz) * tn + sz * h;
    const float h_old = h;
    h = mt * h_new + (1.f - mt) * h;

    // The unit's new h of the four rows, as one 16-byte store into every
    // block's next-h buffer: lane i of the unit's 16 sends to block i.
    if (s + 1 < T) {
      const int unit0 = lane & 16;
      const float4 h4 = make_float4(
          __shfl_sync(kWarp, h, unit0), __shfl_sync(kWarp, h, unit0 + 4),
          __shfl_sync(kWarp, h, unit0 + 8), __shfl_sync(kWarp, h, unit0 + 12));
      if (kl < C)
        st_async4(map_to_rank(smem_addr(h_s + (1 - p) * Hp + col), kl), h4,
                  map_to_rank(smem_addr(bar + (1 - p)), kl));
    }
    if (valid) {
      if (gate == 0) y[(size_t)t * L.y_t + (size_t)(b0 + row) * H + col] = mt * h_new;
      if (kSave) {      // r, z, n from their lanes, ghn from the spare one, h from z's
        const size_t o = ((size_t)d * T + t) * B + b0 + row;
        act[o * 4 * H + gate * H + col] = gate == 0 ? sr : gate == 1 ? sz : gate == 2 ? tn : ghn;
        if (gate == 1) hp[o * H + col] = h_old;
      }
    }
    if (s + 1 < T) fetch(aas_rnn::fwd_time(L, d, s + 1, T));
    p ^= 1;
  }
}

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

// The resident route's launch configuration on clusters of C blocks per
// (direction, tile of rows); 0, or the code of what refuses it.
template <bool kSave>
int resident_config(int C, int B, int H, cudaStream_t stream, cudaLaunchAttribute* attr,
                    cudaLaunchConfig_t* cfg) {
  if (C < 1 || C > kResCluster || H % C) return (int)cudaErrorInvalidValue;
  const int U = H / C;
  if (U % 2 || U > kResUnits) return (int)cudaErrorInvalidValue;
  return aas_rnn::cluster_config(gru_res_fwd_kernel<kSave>, C,
                                 dim3(C * ((B + kRows - 1) / kRows), 2), 16 * U,
                                 res_smem(H, U), stream, attr, cfg);   // a warp per two units
}

template <bool kSave>
int launch_resident(const float* gxf, const float* gxb, const aas_rnn::Layout& L,
                    const float* m, const float* wh, const float* bh, float* yf,
                    float* yb, float* hp, float* act, int C, int T, int B, int H,
                    cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int rc = resident_config<kSave>(C, B, H, stream, attr, &cfg);
  if (rc) return rc;
  // Once per configuration: a cluster that cannot be scheduled is an error
  // here, not a launch that never starts.
  static int checked = 0;             // one per variant: the last shape asked about
  const int key = H * 32 + C;
  if (checked != key) {
    int clusters = 0;
    rc = aas_rnn::active_clusters(gru_res_fwd_kernel<kSave>, cfg, &clusters);
    if (rc) return rc;
    checked = key;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gru_res_fwd_kernel<kSave>, gxf, gxb, L,
                                             m, wh, bh, yf, yb, hp, act, T, B, H, H / C);
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
}

// The GRU's cell backward of one (unit, row) for the resident backward
// kernel (rnn_cluster.cuh): gru_tm_bwd_kernel's arithmetic, with the summed
// partials of dh in and the carry kept in a register.
struct GruBwdCell {
  static constexpr int kGates = 3;
  static constexpr int kOutputs = 2;    // inputs of dh a thread owns: 192 weights
  float carry = 0.f;                    // dh_upd z + (1 - m) dh of the step before

  __device__ __forceinline__ void step(const aas_rnn::BwdIn& in, float part,
                                       float (&gx)[3], float (&gh)[3]) {
    const float r = in.a[0], z = in.a[1], n = in.a[2], ghn = in.a[3];
    const float dh = part + carry;
    const float dh_upd = in.m * (dh + in.dy);
    const float d_z = dh_upd * (in.st - n) * z * (1.f - z);
    const float d_n = dh_upd * (1.f - z) * (1.f - n * n);
    const float d_r = d_n * ghn * r * (1.f - r);
    carry = dh_upd * z + (1.f - in.m) * dh;
    gx[0] = gh[0] = d_r;
    gx[1] = gh[1] = d_z;
    gx[2] = d_n;
    gh[2] = d_n * r;
  }
};

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
// and the buffers the backward reads for training.  `cluster` is the caller's
// choice of route: the resident kernel on clusters of that many blocks, or 0
// for the streaming kernel.
extern "C" int aas_gru_fwd(const float* gx0, const float* gx1, long long gx_t,
                           long long gx_b, const float* m, const float* wh,
                           const float* bh, float* y0, float* y1, float* hp,
                           float* act, int stacked, int cluster, int T, int B, int H,
                           cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, gx_t, gx_b, T, B, H, 3 * H);
  if (cluster > 0) {
    if (hp == nullptr)
      return launch_resident<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr,
                                    cluster, T, B, H, stream);
    return launch_resident<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, act, cluster, T, B,
                                 H, stream);
  }
  if (hp == nullptr)
    return launch_fwd<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr, T,
                             B, H, stream);
  return launch_fwd<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, act, T, B, H, stream);
}

// The clusters of `cluster` blocks of a resident kernel that the card can run
// at once at width H, as cudaOccupancyMaxActiveClusters counts them: the
// forward's inference (variant 0) or training variant (1), or the backward
// (2); minus the error's code where the shape is refused or no such cluster
// can be scheduled.
extern "C" int aas_gru_res_clusters(int cluster, int variant, int H) {
  if (variant == 2) return aas_rnn::res_bwd_clusters<GruBwdCell>(cluster, H);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  int rc = variant ? resident_config<true>(cluster, kRows, H, nullptr, attr, &cfg)
                   : resident_config<false>(cluster, kRows, H, nullptr, attr, &cfg);
  if (!rc)
    rc = variant ? aas_rnn::active_clusters(gru_res_fwd_kernel<true>, cfg, &clusters)
                 : aas_rnn::active_clusters(gru_res_fwd_kernel<false>, cfg, &clusters);
  return rc ? -rc : clusters;
}

// dgx is [2, T, B, 3H] (time-major) or [T, 2, B, 3H] (stacked); dgh
// [2, T, B, 3H] in both, or NULL when no weight gradient is wanted.  As in
// aas_gru_fwd, `cluster` is the route: the resident kernel on clusters of
// that many blocks, w = wh [2, H, 3H]; or 0, the streaming kernel, w = whT
// [2, 3H, H].
extern "C" int aas_gru_bwd(const float* m, const float* w, const float* hp,
                           const float* act, const float* dy0, const float* dy1,
                           float* dgx, float* dgh, int stacked, int cluster, int T, int B,
                           int H, cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, 0, 0, T, B, H, 3 * H);
  if (cluster > 0)
    return aas_rnn::launch_res_bwd<GruBwdCell>(
        aas_rnn::BwdArgs{L, m, w, hp, act, dy0, dy1, dgx, dgh, T, B, H}, cluster, stream);
  return launch_bwd(L, m, w, hp, act, dy0, dy1, dgx, dgh, T, B, H, stream);
}
