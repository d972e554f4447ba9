// Masked GroupNorm + activation, forward: statistics, finalize and apply in
// one cooperative launch.
//
// Replaces: aas_enhancement_tpu/ops/pallas/gn_kernel.py::masked_group_norm_act
// forward: _lane_stats (_stats_kernel), _finalize_stats and _apply
// (_make_apply_kernel).  Same function: over the valid frames t < len[b] of
// x [B, T, F, C], per (b, group) mean and var = max(E[x^2] - mean^2, 0) with
// count = max(len[b] * F * C/G, 1), inv = rsqrt(var + eps); then
// y = act(x * inv_c + off_c) with inv_c = inv * scale[c], off_c = bias[c] -
// mean * inv * scale[c], act none, leaky_relu(slope) or hardtanh(0, 20), and
// y = 0 on padded frames.  The Pallas version runs a stats pass, the finalize
// in XLA and an apply pass; the port's first version did the same with two
// Triton kernels and ~22 small torch kernels between them, which cost the host
// more than the device.  Here it is one kernel: a grid-wide barrier between
// the two passes needs every block resident, so the host launches it with
// cudaLaunchCooperativeKernel at the number of blocks the card holds at once
// (capped by the work).
//
// Work items: (b, a tile of kRows frames, all F*C lanes).  Blocks walk the
// items with a stride of gridDim.x.
// 1. Stats: a thread reads 16 bytes (4 lanes) a load, neighbouring threads
//    neighbouring lanes, only the valid frames.  The block has a multiple of
//    C/4 threads, so a thread's lanes keep the same 4 channels in every
//    column it visits: it sums x and x^2 of its 4 channels in registers.  The
//    block adds them per channel, then per group, in a fixed order, and
//    writes the item's per-group (sum, sum of squares) to partials[item].
// 2. grid.sync().
// 3. Finalize, per block for the batch row of its items: the partials of
//    b's items summed in item order (16 strided parts, then the parts in
//    order), so the bits depend on neither the grid size nor the order in
//    which blocks ran; then mean, inv and each thread's 4 (inv_c, off_c).
//    The block that holds item (b, 0) writes mean and inv per (b, c) for the
//    backward.
// 4. Apply (apply_item): the items again, in reverse order, so that the
//    tiles read last in pass 1 are still in L2; y = act(x * inv_c + off_c)
//    on valid frames, 0 on padded ones, 16-byte loads and stores.  Where x
//    and y together exceed the L2, each thread's columns in reverse order
//    too, and the loads and stores evict-first.
//
// Bound on the H100: bytes.  The function reads x once and writes y once
// (66 MB at the enhancer's [4, 801, 161, 32]: 0.039 ms at 3.35 TB/s); the
// kernel reads x twice, the second time partly from the 50 MB L2.  The
// scratch (partials) is 64 bytes an item.
//
// Layout: x, y [B, T, F, C] contiguous f32 (16-byte aligned), scale, bias [C],
// lengths [B] int32 or int64, mean, inv [B, C], partials [B * n_tiles * G * 2]
// with n_tiles = ceil(T / kRows).  Requires C % 4 == 0, C <= kMaxChannels,
// G | C, G <= kMaxGroups.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;            // frames per work item
constexpr int kThreads = 256;       // largest block; the block is a multiple of C/4
constexpr int kMaxChannels = 256;
constexpr int kMaxGroups = 32;
constexpr int kParts = 16;          // strided parts of the finalize's sums

struct Params {
  const float4* x;
  const float* scale;
  const float* bias;
  const void* lengths;
  float4* y;
  float* mean;
  float* inv;
  float* partials;
  int len64;                        // lengths are int64 (else int32)
  int B, T, F, C, G;
  float eps;
  int act;                          // 0 none, 1 leaky_relu, 2 hardtanh(0, 20)
  float slope;
  int evict;                        // x and y exceed the L2: pass 2 evict-first
};

__device__ __forceinline__ long long length_of(const Params& p, int b) {
  return p.len64 ? static_cast<const long long*>(p.lengths)[b]
                 : (long long)static_cast<const int*>(p.lengths)[b];
}

__device__ __forceinline__ float activate(float z, int act, float slope) {
  if (act == 1) return z >= 0.f ? z : slope * z;
  if (act == 2) return fminf(fmaxf(z, 0.f), 20.f);
  return z;
}

// Pass 2 over one item: y = act(x * inv_c + off_c) on its first `valid` of
// `rows` frames, 0 on the rest.  kEvict (x and y together exceed the L2):
// this thread's columns in reverse order, so that those pass 1 read last come
// first while they are in L2, and x's last use and y evict-first (__ldcs,
// __stcs), so that y does not push x out (on an H100 at the enhancer's 66 MB:
// 0.082 -> 0.072 ms).  Without it, the plain loop: where x and y fit the L2
// the hints gain nothing, and a run-time choice inside the loop cost the AM's
// shapes ~10%.
template <bool kEvict>
__device__ __forceinline__ void apply_item(const Params& p, size_t base, int cols, int rows,
                                           int valid, float4 ic, float4 oc) {
  const int tid = threadIdx.x, step = blockDim.x;
  int col = tid;
  if (kEvict) col = tid < cols ? tid + (cols - 1 - tid) / step * step : -1;
  for (; kEvict ? col >= 0 : col < cols; col += kEvict ? -step : step) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid) {
          const float4* src = p.x + base + (size_t)r * cols + col;
          const float4 v = kEvict ? __ldcs(src) : *src;
          o.x = activate(fmaf(v.x, ic.x, oc.x), p.act, p.slope);
          o.y = activate(fmaf(v.y, ic.y, oc.y), p.act, p.slope);
          o.z = activate(fmaf(v.z, ic.z, oc.z), p.act, p.slope);
          o.w = activate(fmaf(v.w, ic.w, oc.w), p.act, p.slope);
        }
        float4* dst = p.y + base + (size_t)r * cols + col;
        if (kEvict)
          __stcs(dst, o);
        else
          *dst = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gn_act_fwd_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[kThreads][9];          // a thread's 4 sums and 4 squares (+1 pad)
  __shared__ float chan[2][kMaxChannels];     // per channel: sum, sum of squares
  __shared__ float parts[kParts][2 * kMaxGroups];
  __shared__ float stat[2][kMaxGroups];       // per group: mean, inv

  const int tid = threadIdx.x;
  const int nq = p.C / 4;                     // channel quads
  const int quad = tid % nq;                  // this thread's channels 4 quad .. 4 quad + 3
  const int cols = p.F * nq;                  // float4 columns of a frame
  const int cg_size = p.C / p.G;              // channels per group
  const int n_tiles = (p.T + kRows - 1) / kRows;
  const int items = p.B * n_tiles;

  // 1. Stats of each item of this block.
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int row0 = (item - b * n_tiles) * kRows;
    const long long len = length_of(p, b);
    const int valid = (int)max(0LL, min((long long)kRows, min(len, (long long)p.T) - row0));
    float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* xb = p.x + ((size_t)b * p.T + row0) * cols;
    for (int col = tid; col < cols; col += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < valid) {
          const float4 v = xb[(size_t)r * cols + col];
          s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
          q[0] = fmaf(v.x, v.x, q[0]); q[1] = fmaf(v.y, v.y, q[1]);
          q[2] = fmaf(v.z, v.z, q[2]); q[3] = fmaf(v.w, v.w, q[3]);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      red[tid][l] = s[l];
      red[tid][4 + l] = q[l];
    }
    __syncthreads();
    // Per channel: the threads of its quad, in thread order.
    for (int e = tid; e < 2 * p.C; e += blockDim.x) {
      const int which = e / p.C;              // 0 sum, 1 sum of squares
      const int c = e - which * p.C;
      float acc = 0.f;
      for (int t = c / 4; t < blockDim.x; t += nq) acc += red[t][4 * which + c % 4];
      chan[which][c] = acc;
    }
    __syncthreads();
    // Per group: its channels in order.
    for (int e = tid; e < 2 * p.G; e += blockDim.x) {
      const int which = e / p.G;
      const int g = e - which * p.G;
      float acc = 0.f;
      for (int c = g * cg_size; c < (g + 1) * cg_size; ++c) acc += chan[which][c];
      p.partials[((size_t)item * p.G + g) * 2 + which] = acc;
    }
    __syncthreads();                          // red and chan are reused by the next item
  }

  grid.sync();

  // 3-4. Finalize for each batch row met, then apply; this block's items in
  // reverse order.
  const int mine = blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  int stat_b = -1;
  float inv_c[4], off_c[4];
  for (int m = mine - 1; m >= 0; --m) {
    const int item = blockIdx.x + m * gridDim.x;
    const int b = item / n_tiles;
    const int tile = item - b * n_tiles;
    const long long len = length_of(p, b);
    if (b != stat_b) {
      const float* pb = p.partials + (size_t)b * n_tiles * p.G * 2;
      for (int e = tid; e < kParts * 2 * p.G; e += blockDim.x) {
        const int part = e / (2 * p.G);
        const int j = e - part * 2 * p.G;     // g * 2 + which
        float acc = 0.f;
        for (int t = part; t < n_tiles; t += kParts)   // other SMs wrote them: past L1
          acc += __ldcg(pb + (size_t)t * p.G * 2 + j);
        parts[part][j] = acc;
      }
      __syncthreads();
      if (tid < p.G) {
        float s1 = 0.f, s2 = 0.f;
        for (int part = 0; part < kParts; ++part) {
          s1 += parts[part][2 * tid];
          s2 += parts[part][2 * tid + 1];
        }
        const float count = fmaxf((float)len * (float)(p.F * cg_size), 1.f);
        const float mu = s1 / count;
        const float var = fmaxf(s2 / count - mu * mu, 0.f);
        stat[0][tid] = mu;
        stat[1][tid] = rsqrtf(var + p.eps);
      }
      __syncthreads();
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int c = 4 * quad + l;
        const float mu = stat[0][c / cg_size], iv = stat[1][c / cg_size];
        inv_c[l] = iv * p.scale[c];
        off_c[l] = p.bias[c] - (mu * iv) * p.scale[c];
      }
      stat_b = b;
    }
    if (tile == 0) {
      for (int c = tid; c < p.C; c += blockDim.x) {
        p.mean[(size_t)b * p.C + c] = stat[0][c / cg_size];
        p.inv[(size_t)b * p.C + c] = stat[1][c / cg_size];
      }
    }
    const int row0 = tile * kRows;
    const int rows = min(kRows, p.T - row0);
    const int valid = (int)max(0LL, min((long long)rows, len - row0));
    const size_t base = ((size_t)b * p.T + row0) * cols;
    const float4 ic = make_float4(inv_c[0], inv_c[1], inv_c[2], inv_c[3]);
    const float4 oc = make_float4(off_c[0], off_c[1], off_c[2], off_c[3]);
    if (p.evict)
      apply_item<true>(p, base, cols, rows, valid, ic, oc);
    else
      apply_item<false>(p, base, cols, rows, valid, ic, oc);
  }
}

// -> the threads of a block for C channels: the largest multiple of C/4 up
// to kThreads.
int block_threads(int C) { return (kThreads / (C / 4)) * (C / 4); }

}  // namespace

// The launch: refuses (cudaErrorInvalidValue) a shape the kernel does not
// take or a scratch smaller than B * ceil(T / kRows) * G * 2 floats, and
// returns the cooperative launch's error (cudaErrorCooperativeLaunchTooLarge
// if the card cannot hold the grid at once).
extern "C" int aas_gn_act_fwd(const float* x, const float* scale, const float* bias,
                              const void* lengths, int len64, float* y, float* mean,
                              float* inv, float* partials, long long partials_len,
                              int B, int T, int F, int C, int G, float eps, int act,
                              float slope, cudaStream_t stream) {
  if (B < 1 || T < 1 || F < 1 || C < 4 || C % 4 || C > kMaxChannels || G < 1 ||
      G > kMaxGroups || C % G || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * ((T + kRows - 1) / kRows);
  if (partials_len < items * G * 2 || items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(C);
  // Blocks the card holds at once and its L2, per (device, block size): asked once.
  static int cached_device = -1, cached_threads = 0, cached_blocks = 0, cached_l2 = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device || threads != cached_threads) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_act_fwd_kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&cached_l2, cudaDevAttrL2CacheSize, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_device = device;
    cached_threads = threads;
    cached_blocks = per_sm * sms;
  }
  const int grid = items < cached_blocks ? (int)items : cached_blocks;
  Params p;
  p.x = reinterpret_cast<const float4*>(x);
  p.scale = scale;
  p.bias = bias;
  p.lengths = lengths;
  p.y = reinterpret_cast<float4*>(y);
  p.mean = mean;
  p.inv = inv;
  p.partials = partials;
  p.len64 = len64;
  p.B = B;
  p.T = T;
  p.F = F;
  p.C = C;
  p.G = G;
  p.eps = eps;
  p.act = act;
  p.slope = slope;
  p.evict = 2 * (long long)B * T * F * C * (long long)sizeof(float) > cached_l2;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gn_act_fwd_kernel), dim3(grid),
                                    dim3(threads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
