// Shared pieces of the resident kernels in lstm_tm.cu and gru_tm.cu, which
// keep wh[d] in a thread-block cluster (in shared memory for the forwards, in
// registers for the backward): the mbarriers that count the bytes arriving in
// a block's buffers, the st.async store that carries a float4 into another
// block's shared memory and reports it there, the shuffle tree that adds a
// unit's 16 lanes' partial sums, the resident backward kernel of both cells,
// and the host side of a launch on clusters.
//
// The forwards' exchange.  Each block of a cluster owns a slice of the hidden
// units and needs all of h every step.  A unit's new h of a tile's four rows
// is one 16-byte st.async store into the next-h buffer of every block of the
// cluster; the store reports its bytes to an mbarrier of the receiving block,
// so data and signal travel together.  A block starts step s when its barrier
// has counted the 16 H bytes of h[s]: no block-wide and no cluster-wide
// barrier inside the time loop.  h is double-buffered, one mbarrier a buffer.
//
// The backward's exchange is the same mirrored (res_bwd_kernel below): a
// block owns the same units and their gate columns as in the forward, so its
// cell backward needs only its own units' dh, and it owes every block a part
// of dh = dg @ wh[d]^T: for each input k, the sum over its own columns.  It
// sends that partial (four rows, 16 bytes) to the owner of unit k, which adds
// the C partials of its units in rank order.  A reduce-scatter: 16 H bytes
// arrive at each block a step, as in the forward.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rnn_bwd.cuh"

namespace aas_rnn {

constexpr unsigned kWarp = 0xffffffffu;
constexpr int kPortableCluster = 8;     // larger clusters need the kernel's leave

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {   // one arrival a phase
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// The phase's one arrival, which also says how many bytes the phase awaits.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity is complete: its bytes, written by
// any block of the cluster, are then visible.  A wait that never ends is a
// fault of the kernel: it traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && spins > (1 << 26)) __trap();
  }
}

// The address of this block's shared-memory location `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ unsigned map_to_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v (16 bytes) at a (possibly remote) shared-memory address and report
// its bytes to the mbarrier `bar` of the same block.
__device__ __forceinline__ void st_async4(unsigned addr, const float4& v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :
      : "r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
        "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// One level of the add-and-scatter over a unit's 16 lanes: a lane keeps the
// half of its 2 kHalf sums that its bit kHalf selects and adds its partner's.
// After the levels 8, 4, 2, 1 lane v of the 16 holds the total of sum v,
// always added in the same order.  With kSpare every fourth sum (3, 7, 11,
// 15: the GRU's three gates in slots of four) is zero in every lane and stays
// so: the levels that would only exchange zeros skip them.
template <int kHalf, bool kSpare = false>
__device__ __forceinline__ void scatter_add(float (&val)[16], int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    if (kSpare && kHalf >= 4 && (i & 3) == 3) continue;
    const float lo = val[i], hi = val[i + kHalf];
    val[i] = (upper ? hi : lo) + __shfl_xor_sync(kWarp, upper ? lo : hi, kHalf);
  }
}

// A refused call's code, with the runtime's record of it cleared so that the
// next launch's check does not report it again.
inline int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// The launch configuration of `kernel` on clusters of C blocks along x, after
// allowing the kernel its dynamic shared memory and, above the portable
// cluster size of 8, the non-portable size.  attr must live as long as cfg.
template <typename Kernel>
int cluster_config(Kernel kernel, int C, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, cudaLaunchAttribute* attr,
                   cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return refused(err);
  if (C > kPortableCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return refused(err);
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// How many clusters of the configuration the card can run at once.  A cluster
// that cannot be scheduled at all is an error here, not a launch that never
// starts.
template <typename Kernel>
int active_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg, int* clusters) {
  *clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return refused(err);
  return *clusters < 1 ? (int)cudaErrorLaunchOutOfResources : 0;
}

// ---------------------------------------------------------------------------
// The resident backward kernel of both cells (B1' / B7 VJP in lstm_tm.cu,
// B2' / B7' VJP in gru_tm.cu, each with its Cell: the gate math of one
// (unit, row) and how many inputs of dh a thread owns).
//
// One cluster of C blocks per (direction, tile of kBwdRows batch rows); block
// `rank` owns the hidden units [rank U, (rank + 1) U), U = H / C <= 32, and
// their Cell::kGates gate columns g H + u of wh[d]: the forward's slice.  A
// step, each direction walking its time in reverse (bwd_time):
//  1. the cell threads, one per (own unit, row) (row = tid & 3, u = tid >> 2:
//     a warp's loads of the saved tensors are four runs of eight units, and
//     its shared-memory reads and writes below are consecutive words), wait on
//     the mbarrier for this step's partials (none at s = 0: dh starts at
//     zero), add the C partials of their (unit, row) in rank order, then the
//     carry, run the cell backward on what they fetched a step ahead, and put
//     the gate gradients dgh into shared memory: [slot][row], 32 slots a gate;
//  2. one __syncthreads;
//  3. every thread owns Cell::kOutputs inputs k of dh (k = tid + i threads)
//     and keeps wh[d][k, own columns] in registers, loaded once per call
//     (192 floats at H = 512 for the GRU, 128 at H = 256 for the LSTM), so its
//     partial dh[k] of the four rows is a sum over its own slots, read as
//     float4 broadcasts: no exchange between lanes;
//  4. it sends that float4 by one st.async to slot [rank][k - q U] of the
//     owner block q = k / U, whose mbarrier counts the bytes (16 H a step);
//  5. the cell threads store dgx (and dgh where wanted, for the weight
//     gradient) and fetch the next step's saved activations, state, mask and
//     dy: after the sends, off the step's chain of latencies.
// The partials and dgh are double-buffered.  A block writes dgh buffer p at
// step s + 2 only after the __syncthreads of step s + 1, which every thread
// reaches after its last read of buffer p at step s.  Block q sends into this
// block's partial buffer p at step s + 1 only after it has this block's
// partials of step s, which leave after the __syncthreads that follows the
// reads of buffer p at step s.  The last step sends nothing, so a block may
// exit when its loop ends.  A padded row of a tile (B % 4 != 0) reads and
// stores nothing and sends zeros.
//
// What bounds a step is the product, kGates 32 U kRows H FMAs a block
// (196,608 for the GRU at H = 512: 1536 clocks of the SM's FMA rate), then
// the chain of latencies: the st.async hop to the other SMs, the waiting
// warps' poll of the mbarrier, the C-term sum, the cell math and the
// __syncthreads.

constexpr int kBwdRows = 4;        // batch rows of a tile
constexpr int kBwdSlots = 32;      // column slots a gate: the most units of a block
constexpr int kBwdThreads = 256;   // the most threads of a block: 255 registers each

// Threads of a resident backward block at width H: one per `outputs` inputs
// of dh, whole warps, and at least one per (slot, row) of the cell backward.
// The route function of ops/cuda/rnn.py repeats it.
inline int res_bwd_threads(int outputs, int H) {
  const int t = 32 * ((H + 32 * outputs - 1) / (32 * outputs));
  return t < kBwdRows * kBwdSlots ? kBwdRows * kBwdSlots : t;
}

// Its shared memory in bytes: the partials twice (H float4 each), dgh twice
// (gates x 32 slots, a float4 each), two mbarriers.
inline size_t res_bwd_smem(int gates, int H) {
  return 16 * ((size_t)2 * H + 2 * gates * kBwdSlots) + 16;
}

// What a cell thread reads for its (unit, row) at one step.
struct BwdIn {
  float a[4];    // the saved gate activations
  float st;      // the saved state: h (GRU) or c (LSTM)
  float m, dy;   // the mask and the output's cotangent
};

struct BwdArgs {
  Layout L;
  const float* m;
  const float* wh;     // [2, H, G], G = gates x H
  const float* st;     // [2, T, B, H]
  const float* act;    // [2, T, B, 4H]
  const float* dy0;
  const float* dy1;
  float* dgx;          // [2, T, B, G] or the stacked [T, 2, B, G]
  float* dgh;          // [2, T, B, G], or NULL where no weight gradient is wanted
  int T, B, H;
};

template <class Cell>
__global__ void __launch_bounds__(kBwdThreads, 1) res_bwd_kernel(const BwdArgs A) {
  constexpr int kG = Cell::kGates;
  constexpr int kJ = kG * kBwdSlots;           // weights a thread keeps per input of dh
  constexpr int kK = Cell::kOutputs;
  extern __shared__ float4 bwd_smem4[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = A.T, B = A.B, H = A.H, U = H / C, G = kG * H;
  const Layout& L = A.L;
  float4* part_s = bwd_smem4;                  // [2][C][U]: the partials of this block's units
  float4* dg_s = part_s + 2 * H;               // [2][kJ]: dgh of the four rows, by slot
  // bar[p] counts the bytes arriving in partial buffer p (16 H a step).
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(dg_s + 2 * kJ);

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * kBwdRows;
  const int nb = min(kBwdRows, B - b0);
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int row = tid & 3;
  const int u = tid >> 2;                      // a cell thread's own unit
  const bool cell_thread = u < U;
  const int col = rank * U + u;                // its hidden unit
  const bool valid = cell_thread && row < nb;
  const float* dy = d == 0 ? A.dy0 : A.dy1;
  const float* md = A.m + d * L.m_d;
  float* dgx_d = A.dgx + d * L.dg_d;

  // This thread's inputs k of dh: their weights (slots past U are zero), the
  // block that owns unit k and the slot of this block's partial there.
  float w[kK][kJ];
  int owner[kK], dst[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const int k = tid + i * threads;
    owner[i] = k < H ? k / U : -1;
    dst[i] = k < H ? rank * U + k - owner[i] * U : 0;
    const float* wk = A.wh + ((size_t)d * H + (k < H ? k : 0)) * G + rank * U;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int g = j / kBwdSlots, uu = j % kBwdSlots;
      w[i][j] = k < H && uu < U ? __ldg(wk + g * H + uu) : 0.f;
    }
  }
  for (int e = tid; e < H; e += threads)       // buffer 0 holds step 0's partials: none
    part_s[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < 2 * kJ; e += threads)  // slots past U stay zero
    dg_s[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {     // buffer 1 receives the partials of step 0, buffer 0 those of step 1
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bar, 16 * H);
    mbar_expect(bar + 1, 16 * H);
  }

  BwdIn next = {};      // zero for a padded row: its gradients stay zero
  auto fetch = [&](int t) {
    if (valid) {
      const size_t o = ((size_t)d * T + t) * B + b0 + row;
#pragma unroll
      for (int g = 0; g < 4; ++g) next.a[g] = A.act[o * 4 * H + g * H + col];
      next.st = A.st[o * H + col];
      next.m = md[(size_t)t * L.m_t + b0 + row];
      next.dy = dy[(size_t)t * L.y_t + (size_t)(b0 + row) * H + col];
    }
  };
  fetch(bwd_time(L, d, 0, T));

  __syncthreads();
  cluster.sync();       // every block's buffers and mbarriers are ready before any send

  Cell cell;            // the carries of this (unit, row)
  float gx[kG], gh[kG];
  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = bwd_time(L, d, s, T);
    if (cell_thread) {
      // The partials of step s have arrived in buffer p: the phase
      // (s - 1) / 2 of its mbarrier is complete.  Thread 0 then arms the
      // barrier for those of step s + 2.
      if (s > 0) {
        mbar_wait(bar + p, ((s - 1) >> 1) & 1);
        if (tid == 0 && s + 2 < T) mbar_expect(bar + p, 16 * H);
      }
      const float* part = reinterpret_cast<const float*>(part_s + p * H) + tid;
      float dh = 0.f;
      for (int q = 0; q < C; ++q) dh += part[q * 4 * U];    // in rank order
      cell.step(next, dh, gx, gh);
      float* dgs = reinterpret_cast<float*>(dg_s + p * kJ) + tid;
#pragma unroll
      for (int g = 0; g < kG; ++g) dgs[g * 4 * kBwdSlots] = gh[g];
    }
    __syncthreads();

    if (s + 1 < T) {
      float4 acc[kK];
#pragma unroll
      for (int i = 0; i < kK; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* dgv = dg_s + p * kJ;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 g4 = dgv[j];
#pragma unroll
        for (int i = 0; i < kK; ++i) fma4(acc[i], w[i][j], g4);
      }
#pragma unroll
      for (int i = 0; i < kK; ++i)
        if (owner[i] >= 0)
          st_async4(map_to_rank(smem_addr(part_s + (1 - p) * H + dst[i]), owner[i]), acc[i],
                    map_to_rank(smem_addr(bar + (1 - p)), owner[i]));
    }
    if (valid) {
      float* out = dgx_d + (size_t)t * L.dg_t + (size_t)(b0 + row) * G + col;
#pragma unroll
      for (int g = 0; g < kG; ++g) out[g * H] = gx[g];
      if (A.dgh != nullptr) {
        float* oh = A.dgh + (((size_t)d * T + t) * B + b0 + row) * G + col;
#pragma unroll
        for (int g = 0; g < kG; ++g) oh[g * H] = gh[g];
      }
    }
    if (s + 1 < T) fetch(bwd_time(L, d, s + 1, T));
    p ^= 1;
  }
}

// The resident backward's launch configuration on clusters of C blocks per
// (direction, tile of rows); 0, or the code of what refuses it.
template <class Cell>
int res_bwd_config(int C, int B, int H, cudaStream_t stream, cudaLaunchAttribute* attr,
                   cudaLaunchConfig_t* cfg) {
  if (C < 1 || C > 16 || H % C || H / C > kBwdSlots) return (int)cudaErrorInvalidValue;
  const int threads = res_bwd_threads(Cell::kOutputs, H);
  if (threads > kBwdThreads) return (int)cudaErrorInvalidValue;
  return cluster_config(res_bwd_kernel<Cell>, C,
                        dim3(C * ((B + kBwdRows - 1) / kBwdRows), 2), threads,
                        res_bwd_smem(Cell::kGates, H), stream, attr, cfg);
}

template <class Cell>
int launch_res_bwd(const BwdArgs& A, int C, cudaStream_t stream) {
  if (A.T == 0 || A.B == 0) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int rc = res_bwd_config<Cell>(C, A.B, A.H, stream, attr, &cfg);
  if (rc) return rc;
  // Once per configuration: a cluster that cannot be scheduled is an error
  // here, not a launch that never starts.
  static int checked = 0;             // the last shape asked about
  const int key = A.H * 32 + C;
  if (checked != key) {
    int clusters = 0;
    rc = active_clusters(res_bwd_kernel<Cell>, cfg, &clusters);
    if (rc) return rc;
    checked = key;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, res_bwd_kernel<Cell>, A);
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
}

// The clusters of C blocks of the resident backward that the card runs at
// once at width H; minus the error's code where refused.
template <class Cell>
int res_bwd_clusters(int C, int H) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  int rc = res_bwd_config<Cell>(C, kBwdRows, H, nullptr, attr, &cfg);
  if (!rc) rc = active_clusters(res_bwd_kernel<Cell>, cfg, &clusters);
  return rc ? -rc : clusters;
}

}  // namespace aas_rnn
