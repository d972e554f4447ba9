// Masked GroupNorm + activation, forward and backward, each one cooperative
// launch.  The forward (gn_act_fwd_kernel) first, the backward
// (gn_act_bwd_kernel) below, after the forward's launch.
//
// Forward.  Replaces: aas_enhancement_tpu/ops/pallas/gn_kernel.py::masked_group_norm_act
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
// Bound on the H100: bytes.  The function reads x on the valid frames once
// and writes y once (66 MB each at the enhancer's [4, 801, 161, 32], 78% of
// the frames valid: 118 MB, 0.035 ms at 3.35 TB/s); the kernel reads x
// twice, the second time partly from the 50 MB L2.  The
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

template <class P>                  // Params or BwdParams
__device__ __forceinline__ long long length_of(const P& p, int b) {
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

// The blocks of a kernel the card holds at once, and its L2 size, per
// (device, block size): each launch keeps its own, asked once.
struct Residency {
  int device = -1, threads = 0, blocks = 0, l2 = 0;
};

cudaError_t residency(const void* kernel, int threads, Residency& r) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device == r.device && threads == r.threads)) return err;
  int per_sm = 0, sms = 0, l2 = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  r.device = device;
  r.threads = threads;
  r.blocks = per_sm * sms;
  r.l2 = l2;
  return cudaSuccess;
}

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
  static Residency res;
  cudaError_t err = residency(reinterpret_cast<const void*>(gn_act_fwd_kernel), threads, res);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < res.blocks ? (int)items : res.blocks;
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
  p.evict = 2 * (long long)B * T * F * C * (long long)sizeof(float) > res.l2;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gn_act_fwd_kernel), dim3(grid),
                                    dim3(threads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces: aas_enhancement_tpu/ops/pallas/gn_kernel.py::_gn_bwd
// (_bwd_lane_stats, the XLA finalize between, _dx).  Same function, from the
// forward's per-(b, c) mean and inv: on the valid frames t < len[b],
//   x_hat = x * inv - mean * inv,  z = x_hat * scale + bias,
//   dz = dy * act'(z)   (leaky: 1 at z >= 0, else the slope; hardtanh: 1 on
//                        [0, 20], else 0), 0 on padded frames;
// per (b, c) sdz = sum dz and sdzx = sum dz * x_hat over valid (t, f);
//   dbias = sum_b sdz,  dscale = sum_b sdzx  ([C] each);
// per (b, group), with n = max(len[b] * F * C/G, 1) and scale folded into each
// channel before the group sum (scale varies inside a group),
//   s1_g = sum_{c in g} scale_c sdz_c / n,  s2_g = sum_{c in g} scale_c sdzx_c / n;
//   dx = inv * scale * dz - (inv * s1_g + x_hat * inv * s2_g), 0 on padded frames.
// x_hat and z are rounded step by step (__fmul_rn, __fsub_rn, __fadd_rn: never
// contracted into an FMA), so that act' sees the z of the Pallas kernel and
// the plain version, ties at z = 0 and z = 20 included.  The Pallas version
// runs a reduction pass, a finalize in XLA and a dx pass; the port's first
// version did the same with two Triton kernels and ~25 small torch kernels.
// Here it is one kernel, built as the forward:
// 1. Reduce: the work items (b, a tile of kRows frames) with a stride of
//    gridDim.x; 16-byte loads of x and dy on valid frames; a thread's same 4
//    channels in every column it visits (a block is a multiple of C/4
//    threads), their dz and dz * x_hat summed in registers; the block adds
//    them per channel in thread order and writes the item's 2C partial sums.
//    Per channel, not per group: dscale, dbias and the scale fold need them.
// 2. grid.sync().
// 3. Finalize, per block for each batch row it meets: b's partials summed in
//    item order (kParts strided parts, then the parts in order, as the
//    forward), so the bits depend on neither the grid size nor block order;
//    then the group sums and each thread's 4 channels' constants.  The
//    block that holds item (b, 0) writes b's per-channel totals to rowsum.
// 4. dx over the block's items in reverse order (those pass 1 read last are
//    still in L2); where x, dy and dx together exceed the L2, each thread's
//    columns in reverse and evict-first loads and stores (dx_item<true>).
// 5. grid.sync(); the last block sums the rows' totals in batch order and
//    writes dscale and dbias: no float atomics, the same bits on every run
//    whatever the grid.  (Summing all items' partials in one block instead,
//    8 rows of 101 items at the enhancer's shape, kept that block ~30 us
//    past the others on an H100.)
//
// Bound on the H100: bytes.  The function reads x and dy on the valid frames
// once and writes dx once (132 MB each at the enhancer's B=8 [8, 801, 161,
// 32], 76% of the frames valid: 332 MB, 0.099 ms at 3.35 TB/s); the kernel
// reads x and dy twice, the second time partly from L2.
// The scratch is 2C floats an item (207 KB at that shape) and 2C a batch row,
// read back from L2.
//
// Layout: x, dy, dx [B, T, F, C] contiguous f32 (16-byte aligned), scale,
// bias, dscale, dbias [C], lengths [B] int32 or int64, mean, inv [B, C],
// scratch: rowsum [B * 2 * C], then partials [B * n_tiles * 2 * C].  The
// forward's limits on C and G.

namespace {

struct BwdParams {
  const float4* x;
  const float4* dy;
  const float* scale;
  const float* bias;
  const void* lengths;
  const float* mean;
  const float* inv;
  float4* dx;
  float* dscale;
  float* dbias;
  float* rowsum;                    // per batch row: its totals of dz, dz * x_hat
  float* partials;                  // per item: its partial sums of the same
  int len64;
  int B, T, F, C, G;
  int act;
  float slope;
  int evict;                        // x, dy and dx exceed the L2: pass 2 evict-first
};

// One channel's constants for batch row b: inv, mean * inv, scale, bias; and
// (pass 2) a = inv * scale, inv * s1_g, inv * s2_g.
struct Lane {
  float iv, mi, sc, bi, a, s1, s2;
};

// x_hat and dz of one lane (see the head of this section for the rounding).
__device__ __forceinline__ float lane_dz(float xv, float d, const Lane& k, int act,
                                         float slope, float& xhat) {
  xhat = __fsub_rn(__fmul_rn(xv, k.iv), k.mi);
  const float z = __fadd_rn(__fmul_rn(xhat, k.sc), k.bi);
  if (act == 1) return z >= 0.f ? d : slope * d;
  if (act == 2) return z >= 0.f && z <= 20.f ? d : 0.f;
  return d;
}

__device__ __forceinline__ float lane_dx(float xv, float d, const Lane& k, int act,
                                         float slope) {
  float xhat;
  const float dz = lane_dz(xv, d, k, act, slope, xhat);
  return fmaf(k.a, dz, -fmaf(xhat, k.s2, k.s1));
}

__device__ __forceinline__ void load_lanes(const BwdParams& p, int b, int quad, Lane k[4]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int c = 4 * quad + l;
    const float iv = p.inv[(size_t)b * p.C + c];
    k[l].iv = iv;
    k[l].mi = __fmul_rn(p.mean[(size_t)b * p.C + c], iv);
    k[l].sc = p.scale[c];
    k[l].bi = p.bias[c];
  }
}

// Batch row b's per-channel sums of dz (chan[c]) and dz * x_hat (chan[C + c])
// from its items' partials, in a fixed order: kParts strided parts, then the
// parts in order.  Every block that meets b sums the same way, so all see
// the same bits.
__device__ void channel_sums(const BwdParams& p, int b, int n_tiles,
                             float (*parts)[2 * kMaxChannels], float* chan) {
  const int tid = threadIdx.x, n2 = 2 * p.C;
  const float* pb = p.partials + (size_t)b * n_tiles * n2;
  __syncthreads();                            // parts and chan are free
  for (int e = tid; e < kParts * n2; e += blockDim.x) {
    const int part = e / n2;
    const int j = e - part * n2;
    float acc = 0.f;
#pragma unroll 4
    for (int t = part; t < n_tiles; t += kParts)   // other SMs wrote them: past L1
      acc += __ldcg(pb + (size_t)t * n2 + j);
    parts[part][j] = acc;
  }
  __syncthreads();
  for (int j = tid; j < n2; j += blockDim.x) {
    float acc = 0.f;
    for (int part = 0; part < kParts; ++part) acc += parts[part][j];
    chan[j] = acc;
  }
  __syncthreads();
}

// Pass 2 over one item: dx on its first `valid` of `rows` frames, 0 on the
// rest; kEvict as in apply_item.
template <bool kEvict>
__device__ __forceinline__ void dx_item(const BwdParams& p, size_t base, int cols, int rows,
                                        int valid, const Lane k[4]) {
  const int tid = threadIdx.x, step = blockDim.x;
  int col = tid;
  if (kEvict) col = tid < cols ? tid + (cols - 1 - tid) / step * step : -1;
  for (; kEvict ? col >= 0 : col < cols; col += kEvict ? -step : step) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        const size_t at = base + (size_t)r * cols + col;
        if (r < valid) {
          const float4 v = kEvict ? __ldcs(p.x + at) : p.x[at];
          const float4 d = kEvict ? __ldcs(p.dy + at) : p.dy[at];
          o.x = lane_dx(v.x, d.x, k[0], p.act, p.slope);
          o.y = lane_dx(v.y, d.y, k[1], p.act, p.slope);
          o.z = lane_dx(v.z, d.z, k[2], p.act, p.slope);
          o.w = lane_dx(v.w, d.w, k[3], p.act, p.slope);
        }
        if (kEvict)
          __stcs(p.dx + at, o);
        else
          p.dx[at] = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gn_act_bwd_kernel(BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  // Pass 1's per-thread sums (red) and pass 2's strided parts share memory.
  __shared__ float smem[kParts * 2 * kMaxChannels];
  __shared__ float chan[2 * kMaxChannels];    // a batch row's per-channel sums
  __shared__ float grp[2][kMaxGroups];        // its s1_g, s2_g
  float (*red)[9] = reinterpret_cast<float (*)[9]>(smem);    // 4 + 4 sums (+1 pad)
  float (*parts)[2 * kMaxChannels] = reinterpret_cast<float (*)[2 * kMaxChannels]>(smem);

  const int tid = threadIdx.x;
  const int nq = p.C / 4;
  const int quad = tid % nq;
  const int cols = p.F * nq;
  const int cg_size = p.C / p.G;
  const int n_tiles = (p.T + kRows - 1) / kRows;
  const int items = p.B * n_tiles;
  Lane k[4];

  // 1. Per-item, per-channel sums of dz and dz * x_hat.
  int lane_b = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int row0 = (item - b * n_tiles) * kRows;
    const long long len = length_of(p, b);
    const int valid = (int)max(0LL, min((long long)kRows, min(len, (long long)p.T) - row0));
    if (b != lane_b) {
      load_lanes(p, b, quad, k);
      lane_b = b;
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
    const size_t base = ((size_t)b * p.T + row0) * cols;
    for (int col = tid; col < cols; col += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < valid) {
          const size_t at = base + (size_t)r * cols + col;
          const float4 v = p.x[at];
          const float4 d = p.dy[at];
          const float xs[4] = {v.x, v.y, v.z, v.w}, ds[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            float xhat;
            const float dz = lane_dz(xs[l], ds[l], k[l], p.act, p.slope, xhat);
            s[l] += dz;
            q[l] = fmaf(dz, xhat, q[l]);
          }
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
      const int which = e / p.C;              // 0 dz, 1 dz * x_hat
      const int c = e - which * p.C;
      float acc = 0.f;
      for (int t = c / 4; t < blockDim.x; t += nq) acc += red[t][4 * which + c % 4];
      p.partials[(size_t)item * 2 * p.C + e] = acc;
    }
    __syncthreads();                          // red is reused by the next item
  }

  grid.sync();

  // 3-4. Finalize for each batch row met, then dx; this block's items in
  // reverse order.
  const int mine = blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  int stat_b = -1;
  for (int m = mine - 1; m >= 0; --m) {
    const int item = blockIdx.x + m * gridDim.x;
    const int b = item / n_tiles;
    const int tile = item - b * n_tiles;
    const long long len = length_of(p, b);
    if (b != stat_b) {
      channel_sums(p, b, n_tiles, parts, chan);
      if ((b * n_tiles) % gridDim.x == blockIdx.x)   // this block holds item (b, 0)
        for (int j = tid; j < 2 * p.C; j += blockDim.x)
          p.rowsum[(size_t)b * 2 * p.C + j] = chan[j];
      if (tid < p.G) {
        float s1 = 0.f, s2 = 0.f;
        for (int c = tid * cg_size; c < (tid + 1) * cg_size; ++c) {
          s1 = fmaf(p.scale[c], chan[c], s1);
          s2 = fmaf(p.scale[c], chan[p.C + c], s2);
        }
        const float count = fmaxf((float)len * (float)(p.F * cg_size), 1.f);
        grp[0][tid] = s1 / count;
        grp[1][tid] = s2 / count;
      }
      __syncthreads();
      load_lanes(p, b, quad, k);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int g = (4 * quad + l) / cg_size;
        k[l].a = k[l].iv * k[l].sc;
        k[l].s1 = k[l].iv * grp[0][g];
        k[l].s2 = k[l].iv * grp[1][g];
      }
      stat_b = b;
    }
    const int row0 = tile * kRows;
    const int rows = min(kRows, p.T - row0);
    const int valid = (int)max(0LL, min((long long)rows, len - row0));
    const size_t base = ((size_t)b * p.T + row0) * cols;
    if (p.evict)
      dx_item<true>(p, base, cols, rows, valid, k);
    else
      dx_item<false>(p, base, cols, rows, valid, k);
  }

  grid.sync();

  // 5. dscale and dbias: the last block sums the rows' totals in batch order.
  if (blockIdx.x == gridDim.x - 1) {
    for (int j = tid; j < 2 * p.C; j += blockDim.x) {
      float acc = 0.f;
      for (int b = 0; b < p.B; ++b) acc += __ldcg(p.rowsum + (size_t)b * 2 * p.C + j);
      if (j < p.C)
        p.dbias[j] = acc;
      else
        p.dscale[j - p.C] = acc;
    }
  }
}

}  // namespace

// The backward's launch: refuses (cudaErrorInvalidValue) what the forward's
// refuses or a scratch smaller than B * (ceil(T / kRows) + 1) * 2 * C floats, and
// returns the cooperative launch's error.  Its own Residency: the kernel's
// registers and shared memory are its own.
extern "C" int aas_gn_act_bwd(const float* x, const float* dy, const float* scale,
                              const float* bias, const void* lengths, int len64,
                              const float* mean, const float* inv, float* dx, float* dscale,
                              float* dbias, float* scratch, long long scratch_len, int B,
                              int T, int F, int C, int G, int act, float slope,
                              cudaStream_t stream) {
  if (B < 1 || T < 1 || F < 1 || C < 4 || C % 4 || C > kMaxChannels || G < 1 ||
      G > kMaxGroups || C % G || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * ((T + kRows - 1) / kRows);
  if (scratch_len < (items + B) * 2 * C || items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(C);
  static Residency res;
  cudaError_t err = residency(reinterpret_cast<const void*>(gn_act_bwd_kernel), threads, res);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < res.blocks ? (int)items : res.blocks;
  BwdParams p;
  p.x = reinterpret_cast<const float4*>(x);
  p.dy = reinterpret_cast<const float4*>(dy);
  p.scale = scale;
  p.bias = bias;
  p.lengths = lengths;
  p.mean = mean;
  p.inv = inv;
  p.dx = reinterpret_cast<float4*>(dx);
  p.dscale = dscale;
  p.dbias = dbias;
  p.rowsum = scratch;
  p.partials = scratch + (size_t)B * 2 * C;
  p.len64 = len64;
  p.B = B;
  p.T = T;
  p.F = F;
  p.C = C;
  p.G = G;
  p.act = act;
  p.slope = slope;
  p.evict = 3 * (long long)B * T * F * C * (long long)sizeof(float) > res.l2;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gn_act_bwd_kernel), dim3(grid),
                                    dim3(threads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
