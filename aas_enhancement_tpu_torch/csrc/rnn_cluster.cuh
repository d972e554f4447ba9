// Shared pieces of the resident forward kernels in lstm_tm.cu and gru_tm.cu,
// which keep wh[d] in the shared memory of a thread-block cluster: the
// mbarriers that count the bytes of h arriving in a block's buffers, the
// st.async store that carries h into another block's shared memory and
// reports it there, the shuffle tree that adds a unit's 16 lanes' partial
// sums, and the host side of a launch on clusters.
//
// The exchange.  Each block of a cluster owns a slice of the hidden units and
// needs all of h every step.  A unit's new h of a tile's four rows is one
// 16-byte st.async store into the next-h buffer of every block of the
// cluster; the store reports its bytes to an mbarrier of the receiving block,
// so data and signal travel together.  A block starts step s when its barrier
// has counted the 16 H bytes of h[s]: no block-wide and no cluster-wide
// barrier inside the time loop.  h is double-buffered, one mbarrier a buffer.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace aas_rnn
