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
// inside the kernel, one (direction, tile of kRows batch rows) per block or
// per cluster of blocks.
//
// Bound on the H100: the recurrence is T dependent steps, and each step needs
// all of wh[d] (H x 4H f32 = 1 MiB at H = 256), more than one SM's 227 KB of
// shared memory.  Two forward kernels, chosen by the shape alone
// (ops/cuda/rnn.py::lstm_resident_cluster):
//
// Resident (lstm_res_fwd_kernel), where a cluster of C <= 8 blocks can hold
// wh[d]: block r of the cluster owns the hidden units [r U, (r + 1) U),
// U = H / C <= 32 and even, and the 4 U gate columns i, f, g, o of those
// units, so the cell update needs no exchange.  It loads its H x 4U slice of
// wh[d] into shared memory once per call (128 KB at H = 256, C = 8) as float4
// (i, f, g, o) per (input, unit).  A warp serves two units and a unit's 16
// lanes split its inputs: lane kl takes inputs kl, kl + 16, ..., and for each
// reads one float4 of weights (a warp's 32 loads are contiguous: no bank
// conflicts) and one float4 of h, the tile's four rows (the two units read
// the same 16: a broadcast), for 16 FMAs into its 16 (row, gate) sums.  The
// weights of a lane's first 8 inputs also stay in registers (half of the
// slice at H = 256): the sweep is bound by shared-memory loads, not by FMAs.
// Four levels of shuffles then add the 16 lanes' sums and scatter them, each
// level halving what a lane keeps, so that lane (row, gate) ends with that
// one total, always added in the same order: no pass through shared memory
// and no block-wide barrier anywhere in the loop.  Each lane applies its
// gate's activation, the four lanes of a (unit, row) share the four values
// and update the same c and h in registers, and the unit's new h of the four
// rows goes as one 16-byte store into the next-h buffer of every block of the
// cluster through distributed shared memory: lane i of the unit's 16 sends to
// block i.  Those writes are st.async stores that each report their 16 bytes
// to an mbarrier of the receiving block (one per h buffer): a block starts
// step s when its barrier has counted the 16 H bytes of h[s], so data and
// signal travel together and there is no cluster-wide barrier in the loop
// either (rnn_cluster.cuh has these pieces; the GRU's resident kernel shares
// them).  h is double-buffered, and that alone keeps a fast block (or warp)
// from overwriting what a slow one still reads: to write h[s + 2] into a
// neighbour's buffer a block needs all of h[s + 1], the part of every warp of
// the neighbour included, which each of them sends only after its last read
// of h[s].  The last step sends nothing, so a block may exit when its loop
// ends.  The stores to global memory (y and what the training variant saves)
// and the loads of the next step's gx and mask come after the sends: they
// depend on no h.  Every block of a cluster walks all T steps and sends every
// h, whatever the tile's number of real rows (a padded row has gx = 0, m = 0
// and stores nothing to global memory).
//
// What bounds a step (NVIDIA H100 80GB HBM3, 700.00 W, T = 801, B = 4,
// H = 256: 2.0 us a step, 1.61 ms a call on the device alone and 1.73 between
// two events around the wrapper, where the streaming kernel takes 23 us and
// 19.0 ms): the sweep (131,072 FMAs = 1024 clocks of the SM's FMA
// rate, and as many clocks of shared-memory loads once half the weights sit
// in registers), then a chain of latencies in sequence: four shuffle levels,
// the activations (expf and a division, two tanhf one after the other),
// eight more shuffles, the store's hop to seven other SMs and the waiting
// warps' poll of the mbarrier.  Not L2 any more.  Earlier designs of the same
// exchange, on the same card: partial sums through shared memory, a 16-way
// reduction by 128 cell threads and a cluster barrier per step 2.54 ms; the
// same with the mbarrier exchange 2.33.
//
// Streaming (lstm_tm_fwd_kernel), for the shapes no cluster of <= 8 blocks
// can hold (H = 512: 4 MiB): one block per (direction, kRows rows) streams
// wh[d] from L2 every step, bounded by one SM's L2 bandwidth (about 1 MiB per
// step at H = 256 whatever the batch, 23 us a step).  One thread per gate
// column, so the loads are coalesced, and each wh element feeds kRows FMAs.
//
// Training forward (kSave): either forward kernel also writes, per direction and
// natural time index, the pre-update state h, c ([2, T, B, H] each) and the
// gate activations sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o)
// ([2, T, B, 4H]).  The Pallas VJP saves h and c and recomputes the gates in
// its backward, which would need the forward's product again every step;
// with the activations saved the backward's only product is the transposed
// one (32 MB more per layer at B = 8, T = 801).
//
// Backward, as _lstm_tm_bwd_kernel, walking each direction's time in reverse
// (direction 0 t = T-1..0, direction 1 t = 0..T-1) and carrying dh and dc:
//   dh_upd = m (dh + dy[t]);  dc_upd = m dc
//   do = dh_upd tanh(c') so (1 - so);  dc' = dh_upd so (1 - tanh^2 c') + dc_upd
//   df = dc' c sf (1 - sf);  di = dc' tg si (1 - si);  dg = dc' si (1 - tg^2)
//   dc <- dc' sf + (1 - m) dc;   dh <- [di, df, dg, do] @ wh[d]^T + (1 - m) dh
// It writes dgx [2, T, B, 4H] (the gradient of gxf and gxb); dWh and dbh are
// sums over time of products of that with h, done by the wrapper in
// torch.matmul as the JAX VJP does them outside its kernel.  Two kernels,
// chosen by the shape alone (ops/cuda/rnn.py::bwd_resident_cluster: the
// forward's route):
//
// Resident (rnn_cluster.cuh::res_bwd_kernel<LstmBwdCell>), wherever the
// resident forward runs (H <= 256): the forward's cluster and ownership, the
// slice in registers (one input of dh x 128 columns in each of 256 threads
// at H = 256), each block's part of dh reduce-scattered to the units' owners
// through distributed shared memory.  Bound by the product (131,072 FMAs a
// block and step at H = 256) and the exchange's latency: 1.97 us a step,
// 1.58 ms at T = 801, B = 8 on the device, on an NVIDIA H100 80GB HBM3
// (700 W).
//
// Streaming (lstm_tm_bwd_kernel), for H = 512 (beside the streaming forward:
// 128 weights a thread in 512 threads would need 2 x 65,536 registers) and as
// the measurement's other side (route 0): one block per (direction, kRows
// rows) keeps dh, dc and the gate gradients in shared memory and streams whT
// [2, 4H, H] (transposed once per call by the wrapper) through rnn_bwd.cuh's
// product: bound by one SM's read of wh[d]^T (1 MiB at H = 256) per step:
// 12.1 us a step on the device at H = 256 (9.7 ms at T = 801, B = 8) on an
// NVIDIA H100 80GB HBM3 (700 W).
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
constexpr int kRegChunks = 8;       // chunks of the slice a lane also keeps in registers

// The resident kernel's shared memory in bytes: the slice (padded to whole
// 16-input chunks), h twice, two mbarriers.  The route function of
// ops/cuda/rnn.py repeats it to pick the cluster size.
inline int res_chunks(int H) { return (H + 15) / 16; }

inline size_t res_smem(int H, int U) {
  const size_t J = res_chunks(H);
  return ((size_t)U * J * 16 + 2 * 16 * J + 1) * sizeof(float4);
}

// val[row][gate] += h[row] * w[gate]
__device__ __forceinline__ void fma_rows(float (&val)[16], const float4& hv, const float4& w) {
  const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    val[4 * rr] = fmaf(hr[rr], w.x, val[4 * rr]);
    val[4 * rr + 1] = fmaf(hr[rr], w.y, val[4 * rr + 1]);
    val[4 * rr + 2] = fmaf(hr[rr], w.z, val[4 * rr + 2]);
    val[4 * rr + 3] = fmaf(hr[rr], w.w, val[4 * rr + 3]);
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kResUnits * 16, 1)
lstm_res_fwd_kernel(const float* __restrict__ gxf, const float* __restrict__ gxb,
                    const aas_rnn::Layout L, const float* __restrict__ m,
                    const float* __restrict__ wh, const float* __restrict__ bh,
                    float* __restrict__ yf, float* __restrict__ yb,
                    float* __restrict__ hp, float* __restrict__ cp,
                    float* __restrict__ act, int T, int B, int H, int U) {
  static_assert(kRows == 4, "a lane's 16 sums are 4 rows x 4 gates");
  extern __shared__ float4 res_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();       // H / U
  const int r = (int)cluster.block_rank();
  const int J = (H + 15) / 16;                   // chunks of 16 inputs, one per lane of a unit
  const int Hp = 16 * J;
  float4* w_s = res_smem4;                       // [U / 2][J][2][16]: (i, f, g, o) per input
  float4* h_s = w_s + (size_t)U * Hp;            // [2][Hp]: h of the four rows, double-buffered
  // bar[p] counts the bytes arriving in h buffer p (16 H a step).
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(h_s + 2 * Hp);

  const int G = 4 * H;
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
  const int gate = lane & 3;
  const int col = r * U + 2 * warp + uu;         // hidden unit
  const bool valid = row < nb;

  // This block's slice of wh[d], once per call; inputs past H are zero.
  {
    const float* w = wh + (size_t)d * H * G + r * U;
    float* w_f = reinterpret_cast<float*>(w_s);
    const int n = Hp * 4 * U;
    for (int e = tid; e < n; e += blockDim.x) {
      const int eu = e % U;
      const int g = (e / U) % 4;
      const int k = e / (4 * U);
      const size_t slot = (((size_t)(eu >> 1) * J + (k >> 4)) * 2 + (eu & 1)) * 16 + (k & 15);
      w_f[slot * 4 + g] = k < H ? w[(size_t)k * G + g * H + eu] : 0.f;
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

  const float bias = bh[(size_t)d * G + gate * H + col];
  float c = 0.f, h = 0.f;                        // the same in a cell's four lanes
  float gx_next = 0.f, m_next = 0.f;
  auto fetch = [&](int t) {     // this lane's gx and the mask of time index t, for a real row
    if (valid) {
      gx_next = gx[(size_t)t * L.gx_t + (size_t)(b0 + row) * L.gx_b + gate * H + col];
      m_next = md[(size_t)t * L.m_t + b0 + row];
    }
  };
  fetch(aas_rnn::fwd_time(L, d, 0, T));
  const float4* wl = w_s + (size_t)warp * J * 32 + lane;

  __syncthreads();
  cluster.sync();       // every block's buffers and mbarriers are ready before any send

  // Where the slice has that many, a lane keeps its weights of the first
  // kRegChunks chunks in registers: the sweep is bound by shared-memory
  // loads, and these are half of them at H = 256.
  const bool in_regs = J >= kRegChunks;
  float4 wreg[kRegChunks];
#pragma unroll
  for (int j = 0; j < kRegChunks; ++j)
    wreg[j] = in_regs ? wl[32 * j] : make_float4(0.f, 0.f, 0.f, 0.f);

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = aas_rnn::fwd_time(L, d, s, T);

    // h[s] has arrived in buffer p: the phase (s - 1) / 2 of its mbarrier is
    // complete.  Thread 0 then arms the barrier for h[s + 2].
    if (s > 0) {
      mbar_wait(bar + p, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < T) mbar_expect(bar + p, 16 * H);
    }

    // This lane's inputs (kl, kl + 16, ...) into the unit's 16 sums.
    float val[16];          // [row][gate]
#pragma unroll
    for (int v = 0; v < 16; ++v) val[v] = 0.f;
    const float4* hc = h_s + p * Hp + kl;
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < kRegChunks; ++j) fma_rows(val, hc[16 * j], wreg[j]);
    }
#pragma unroll 4
    for (int j = in_regs ? kRegChunks : 0; j < J; ++j) fma_rows(val, hc[16 * j], wl[32 * j]);
    // Add over the unit's lanes and scatter, so that lane v of the 16 ends
    // with sum v, always added in the same order.
    scatter_add<8>(val, lane);
    scatter_add<4>(val, lane);
    scatter_add<2>(val, lane);
    scatter_add<1>(val, lane);

    // Each lane its gate's activation; the cell's four lanes then share them
    // and update the same (h, c).
    const float pre = gx_next + (val[0] + bias);
    const float a = gate == 2 ? tanhf(pre) : sigmoid(gate == 1 ? pre + 1.f : pre);
    const int cell0 = lane & ~3;
    const float si = __shfl_sync(kWarp, a, cell0);
    const float sf = __shfl_sync(kWarp, a, cell0 + 1);
    const float tg = __shfl_sync(kWarp, a, cell0 + 2);
    const float so = __shfl_sync(kWarp, a, cell0 + 3);
    const float mt = m_next;
    const float c_new = sf * c + si * tg;
    const float h_new = so * tanhf(c_new);
    const float h_old = h, c_old = c;
    h = mt * h_new + (1.f - mt) * h;
    c = mt * c_new + (1.f - mt) * c;

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
      const size_t o = ((size_t)d * T + t) * B + b0 + row;
      if (gate == 0) {
        y[(size_t)t * L.y_t + (size_t)(b0 + row) * H + col] = mt * h_new;
        if (kSave) {
          hp[o * H + col] = h_old;
          cp[o * H + col] = c_old;
        }
      }
      if (kSave) act[o * G + gate * H + col] = a;
    }
    if (s + 1 < T) fetch(aas_rnn::fwd_time(L, d, s + 1, T));
    p ^= 1;
  }
}

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

// The resident route's launch configuration on clusters of C blocks per
// (direction, tile of rows); 0, or the code of what refuses it.
template <bool kSave>
int resident_config(int C, int B, int H, cudaStream_t stream, cudaLaunchAttribute* attr,
                    cudaLaunchConfig_t* cfg) {
  if (C < 1 || C > aas_rnn::kPortableCluster || H % C) return (int)cudaErrorInvalidValue;
  const int U = H / C;
  if (U % 2 || U > kResUnits) return (int)cudaErrorInvalidValue;
  return aas_rnn::cluster_config(lstm_res_fwd_kernel<kSave>, C,
                                 dim3(C * ((B + kRows - 1) / kRows), 2), 16 * U,
                                 res_smem(H, U), stream, attr, cfg);   // a warp per two units
}

template <bool kSave>
int launch_resident(const float* gxf, const float* gxb, const aas_rnn::Layout& L,
                    const float* m, const float* wh, const float* bh, float* yf,
                    float* yb, float* hp, float* cp, float* act, int C, int T, int B,
                    int H, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  auto kernel = lstm_res_fwd_kernel<kSave>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int rc = resident_config<kSave>(C, B, H, stream, attr, &cfg);
  if (rc) return rc;

  // Once per configuration: a cluster that cannot be scheduled is an error
  // here, not a launch that never starts.
  static int checked = 0;             // one per variant: the last shape asked about
  const int key = H * 16 + C;
  if (checked != key) {
    int clusters = 0;
    rc = aas_rnn::active_clusters(kernel, cfg, &clusters);
    if (rc) return rc;
    checked = key;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, gxf, gxb, L, m, wh, bh, yf,
                                             yb, hp, cp, act, T, B, H, H / C);
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
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

// The LSTM's cell backward of one (unit, row) for the resident backward
// kernel (rnn_cluster.cuh): lstm_tm_bwd_kernel's arithmetic, with the summed
// partials of dh in and the carries kept in registers.
struct LstmBwdCell {
  static constexpr int kGates = 4;
  static constexpr int kOutputs = 1;    // inputs of dh a thread owns: 128 weights
  float carry = 0.f;                    // (1 - m) dh of the step before
  float dc = 0.f;

  __device__ __forceinline__ void step(const aas_rnn::BwdIn& in, float part,
                                       float (&gx)[4], float (&gh)[4]) {
    const float si = in.a[0], sf = in.a[1], tg = in.a[2], so = in.a[3], c = in.st;
    const float tc = tanhf(sf * c + si * tg);
    const float dh = part + carry;
    const float dh_upd = in.m * (dh + in.dy);
    const float dc_new = dh_upd * so * (1.f - tc * tc) + in.m * dc;
    gx[0] = gh[0] = dc_new * tg * si * (1.f - si);
    gx[1] = gh[1] = dc_new * c * sf * (1.f - sf);
    gx[2] = gh[2] = dc_new * si * (1.f - tg * tg);
    gx[3] = gh[3] = dh_upd * tc * so * (1.f - so);
    dc = dc_new * sf + (1.f - in.m) * dc;
    carry = (1.f - in.m) * dh;
  }
};

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
// inference and the buffers the backward reads for training.  `cluster` is
// the caller's choice of route: the resident kernel on clusters of that many
// blocks, or 0 for the streaming kernel.
extern "C" int aas_lstm_fwd(const float* gx0, const float* gx1, long long gx_t,
                            long long gx_b, const float* m, const float* wh,
                            const float* bh, float* y0, float* y1, float* hp,
                            float* cp, float* act, int stacked, int cluster, int T,
                            int B, int H, cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, gx_t, gx_b, T, B, H, 4 * H);
  if (cluster > 0) {
    if (hp == nullptr)
      return launch_resident<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr,
                                    nullptr, cluster, T, B, H, stream);
    return launch_resident<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, cp, act, cluster,
                                 T, B, H, stream);
  }
  if (hp == nullptr)
    return launch_fwd<false>(gx0, gx1, L, m, wh, bh, y0, y1, nullptr, nullptr,
                             nullptr, T, B, H, stream);
  return launch_fwd<true>(gx0, gx1, L, m, wh, bh, y0, y1, hp, cp, act, T, B, H,
                          stream);
}

// The clusters of `cluster` blocks of a resident kernel that the card can run
// at once at width H, as cudaOccupancyMaxActiveClusters counts them: the
// forward's inference (variant 0) or training variant (1), or the backward
// (2); minus the error's code where the shape is refused or no such cluster
// can be scheduled.
extern "C" int aas_lstm_res_clusters(int cluster, int variant, int H) {
  if (variant == 2) return aas_rnn::res_bwd_clusters<LstmBwdCell>(cluster, H);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  int rc = variant ? resident_config<true>(cluster, kRows, H, nullptr, attr, &cfg)
                   : resident_config<false>(cluster, kRows, H, nullptr, attr, &cfg);
  if (!rc)
    rc = variant ? aas_rnn::active_clusters(lstm_res_fwd_kernel<true>, cfg, &clusters)
                 : aas_rnn::active_clusters(lstm_res_fwd_kernel<false>, cfg, &clusters);
  return rc ? -rc : clusters;
}

// dgx is [2, T, B, 4H] (time-major) or [T, 2, B, 4H] (stacked).  As in
// aas_lstm_fwd, `cluster` is the route: the resident kernel on clusters of
// that many blocks, w = wh [2, H, 4H]; or 0, the streaming kernel, w = whT
// [2, 4H, H].
extern "C" int aas_lstm_bwd(const float* m, const float* w, const float* cp,
                            const float* act, const float* dy0, const float* dy1,
                            float* dgx, int stacked, int cluster, int T, int B, int H,
                            cudaStream_t stream) {
  const aas_rnn::Layout L = aas_rnn::make_layout(stacked, 0, 0, T, B, H, 4 * H);
  if (cluster > 0)
    return aas_rnn::launch_res_bwd<LstmBwdCell>(
        aas_rnn::BwdArgs{L, m, w, cp, act, dy0, dy1, dgx, nullptr, T, B, H}, cluster,
        stream);
  return launch_bwd(L, m, w, cp, act, dy0, dy1, dgx, T, B, H, stream);
}
