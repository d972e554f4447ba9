// Weight gradient of a SAME-padded 2-D convolution, time stride 1.
//
// Replaces: aas_enhancement_tpu/ops/pallas/conv_dw_kernel.py::conv_dw_same
// (:161; stride (1, 1) through conv_dw_s1 :106, stride (1, 2) through its
// frequency phase split).  Same function:
//   dW[dt, df, ci, co] = sum_{b, t, f} x[b, t + dt - pt0, s f + df - pf0, ci]
//                                      * dy[b, t, f, co]
// with x [B, T, F, ci], dy [B, T, Fo, co] (Fo = ceil(F / s)), SAME padding
// (pt0, pf0 on the low side, the odd pad on the high side), x read as zero
// outside [0, T) x [0, F), and an f32 sum.
//
// The Pallas kernel packs the taps into the two output dims of one matmul
// (352 x 672 at the acoustic model's 11 x 21 conv) because the TPU's matrix
// unit wants 128 x 128 outputs, reads x under a second, shifted BlockSpec for
// the time halo, pads F to the sublane tile, and needs a phase split of x
// for stride 2.  None of that carries over: here the stride and the padding
// are index arithmetic on staged rows, and one kernel serves both strides.
//
// Three routes, picked by the wrapper's plan (ops/cuda/conv_dw.py::
// conv_dw_plan) from the shape and the input dtype; each writes per-slice
// partial sums part[slice] and conv_dw_reduce_kernel adds the slices in
// order, so the result does not depend on the schedule: two runs give the
// same bits.  No atomics.  dW [kt, kf, ci, co] f32, contiguous; part
// [slices, kt, kf, ci, co].
//
// Layout: x and dy have unit channel stride and strides (b, t, f) in
// elements, so both a contiguous [B, T, F, C] tensor and the channels-last
// memory of an NCHW tensor are read in place.  16-byte copies where the
// strides and the base allow, scalar loads otherwise.
//
// f32 inputs, where the split route's stages do not fit a block's shared
// memory ("fma", conv_dw_kernel).  Bound on the H100: operations.  At the
// acoustic model's conv2 (B = 8, T = 401, F = 81 -> 41, 32 -> 32 channels,
// 11 x 21 taps) it is 62 GFLOP on 50 MB of input, 0.93 ms at the card's 67
// TFLOP/s of f32 FMAs against 0.015 ms of memory traffic, so the design
// keeps the FMA pipes fed from registers and shared memory:
// - a block owns `ndt` time taps, a few chunks of kTaps frequency taps and a
//   slice of the (b, t) rows; per row it stages the dy row [Fo, co] and the
//   `ndt` x rows [s (Fo - 1) + taps, ci] it needs (zero where x is padding) in
//   shared memory, double-buffered with cp.async so the next row loads while
//   this one is multiplied;
// - a thread keeps a 4 ci x 4 co register tile for each of its kTaps taps
//   (16 kTaps accumulators); per output position it reads one float4 of dy
//   and kTaps float4 of x from shared memory (the warp's threads share them:
//   broadcasts) for 16 kTaps FMAs.
// Channels are padded to a multiple of 4 in shared memory.
//
// bf16 inputs ("mma", conv_dw_mma_kernel<CX, CD, 1>; a bf16 AM's conv2).  A
// product of two bf16 values is exact in f32, so bf16 x bf16 -> f32
// tensor-core products summed in f32 compute what the plain version and the
// Pallas kernel (preferred_element_type f32) compute, in another order.
// Bound: operations at the 989 TFLOP/s bf16 rate (0.063 ms at conv2, B = 8,
// against 0.0075 ms for the 25 MB of x and dy).  Per tap the work is an
// implicit GEMM, M = ci, N = co, contraction K over the positions (b, t, f):
// - a block owns one chunk of ci (up to 32 channels), one of co (up to 32),
//   `per_block` consecutive taps (dt-major, so they span `ndt` time taps)
//   and a slice of the (b, t) rows; each of its 8 multiplying warps owns
//   32 / (MT NT) of the taps, each a full tile of MT x NT m16n8 accumulators
//   (128 f32 registers a thread in all);
// - K runs over a window's (row, bin) positions, 16 at a time, with no
//   padding of Fo: each lane of `ldmatrix.trans` gives the address of its own
//   position's row, so dy's fragment is position k's dy row and tap (dt,
//   df)'s A fragment is x's staged row (i + dt - dt_min, s f + df): the taps
//   and the stride are only different row addresses.  dy's fragment serves
//   all of the warp's taps; mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32
//   does the products, and the next tap's fragment loads while a tap's
//   products run;
// - a fourth warpgroup stages the windows (up to `win` dy rows of one
//   utterance and the win + ndt - 1 x rows they read, bf16 as bf16, 16-byte
//   cp.async; scalar loads where a row forbids them) into two stages, each
//   while the multiplying warps work on the other, handing them over with
//   named barriers; setmaxnreg gives it 40 registers a thread and the
//   multiplying warps 232.  Each staged x row serves every time tap that
//   reads it.  An x row is staged phase-split (position s j + ph at row
//   ph half + j) in slots of xp = Fo mod 8 rows, so that a tap reads
//   consecutive rows for consecutive bins whatever the stride, and a lane's
//   rows move by multiples of 8 from step to step;
// - staged rows are 16, 32 or 64 bytes; chunk c of row r sits at c ^ h(r),
//   which puts any 8 consecutive rows read at one chunk in 8 distinct
//   16-byte bank groups, so ldmatrix's gathers are free of bank conflicts
//   (across a dy row's end too, as the rows move by multiples of 8), and a
//   lane's chunk XOR, hence its address offsets, stay fixed all window long;
// - channels past ci or co, positions past the window and SAME padding are
//   zeros in shared memory;
// - the tensor cores' f32 sums do not round to nearest, so their error grows
//   with the run: a warp adds its sums into part[slice] every ~128 dy rows
//   and restarts from zero, so that the error does not grow with the batch.
//
// f32 inputs ("bf16x3", conv_dw_mma_kernel<CX, CD, 3>; an f32 AM's conv2,
// wherever its stages fit).  The FMA route cannot pass 0.93 ms at conv2 (67
// TFLOP/s); the tensor cores can, if they keep f32's accuracy (TF32 keeps 10
// bits: not enough).  So each f32 value is split into three bf16 values, v =
// v0 + v1 + v2 with vk = bf16_rn(v - v0 - ... - v(k-1)), the subtractions
// exact: 8 + 9 + 9 bits with round-to-nearest hold f32's 24 (exactly, where
// the planes stay above bf16's subnormals, |v| > 2^-108 or so; values past
// bf16's largest, 3.39e38, overflow).  Of the nine products the six of order
// at most 2^-16 are kept, x0 d0, x0 d1, x1 d0, x0 d2, x1 d1, x2 d0; each is
// exact in f32, and the three left out are below 3 2^-24 of |x d|, f32's
// rounding.  Six m16n8k16 products cost the tensor time of three TF32 ones
// (3xTF32), and the bound is 6 x the operations at 989 TFLOP/s (0.377 ms at
// conv2, B = 8).  The split keeps the operands 16-bit, so the bf16 route's
// pipeline serves as it is (ldmatrix.trans takes no 32-bit elements, and
// wgmma takes TF32 only K-major, which positions-major rows are not):
// - the staged window is three planes, each laid out as the bf16 route's
//   (same rows, same swizzle), dy's three then x's three, and a lane's
//   address in plane q is its address in plane 0 plus q planes: three rows
//   in place of one row of 3 x 8 cx channels, because the swizzle wants 1, 2
//   or 4 chunks a row, and so the gathers, their bank spread and the address
//   arithmetic are the bf16 route's unchanged;
// - the staging warps load each chunk's 32 bytes of f32 into registers by
//   two 16-byte loads, split them and store the chunk's three planes (as
//   fast as cp.async of the raw floats into the stage and a second pass that
//   splits them there, and simpler; PERF.md);
// - per k16 step and tap a warp loads three x and three dy fragments (dy's
//   serve all of the warp's taps), issues the six products from zero into a
//   tile of their own, smallest first (x0 d2, x1 d1, x2 d0; x0 d1, x1 d0;
//   x0 d0), and adds that tile to the running sums with f32 adds, rounded to
//   nearest: the tensor cores' truncation is then relative to a 16-position
//   sum, and the running sums round as the FMA route's do, so the flush
//   stays at ~128 dy rows (six truncating updates a step straight into the
//   running sums needed a flush every few windows, whose loads stalled the
//   warps, and still lost ten times the accuracy);
// - a warp holds half the bf16 route's taps (64 accumulators a thread where
//   a tile is 32 x 32), and the block's taps come in more groups: dy's three
//   fragments take 24 registers, the x fragments 24 (prefetched one m16 row
//   of one tap at a time, double-buffered), the product tile 16 (one m16
//   row at a time), within the launch's 168 registers a thread, which ptxas
//   allocates the whole kernel in whatever setmaxnreg gives the multiplying
//   warps (with two staging warpgroups, 128 a thread, these instances
//   spilled; PERF.md);
// - the planes' x rows share one zeroed tail a stage after the last plane
//   (a plane's reads past its rows land in the next plane), which leaves room
//   at conv2 for windows of 3 dy rows (2 with a tail each);
// - the staging warpgroup keeps 56 registers a thread (setmaxnreg; the
//   multiplying warps 224) for the split of a chunk's eight floats.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kMaxStageBytes = 227 * 1024;   // shared memory of one sm_90 block

// ------------------------------------------------------------ f32: "fma"

struct Params {
  const float* x;
  const float* dy;
  float* part;
  long long xs_b, xs_t, xs_f;   // x strides in elements (channel stride 1)
  long long ds_b, ds_t, ds_f;   // dy strides in elements (channel stride 1)
  int T, F, Fo, ci, co, kt, kf, sf, pt0, pf0;
  int rows;                     // B * T
  int rows_per_slice;
  int ci4, co4;                 // channel groups of 4: ceil(ci / 4), ceil(co / 4)
  int ndt;                      // time taps per block
  int ndfc, ndfb;               // frequency-tap chunks: in all, per block
  int fpad;                     // staged x row length, in frequency positions
  int vec_x, vec_dy;            // 16-byte loads of 4 channels allowed
};

// Four channels of a row into shared memory, zero past the first `n`: one
// 16-byte cp.async (`vec`), or scalar loads.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool vec, int n) {
  if (vec) {
    __pipeline_memcpy_async(dst, src, 16);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = k < n ? __ldg(src + k) : 0.f;
}

// Stage row r = (b, t): dy[b, t] -> dy_s [Fo][4 co4], and for each of the
// block's time taps x[b, t + dt - pt0] -> x_s [ndt][fpad][4 ci4], position
// fp holding frequency fp - pf0, zeros where x is padding.
__device__ __forceinline__ void stage_row(const Params& p, int r, int dt0,
                                          float* __restrict__ dy_s,
                                          float* __restrict__ x_s) {
  const int b = r / p.T;
  const int t = r - b * p.T;
  const int cop = 4 * p.co4;
  const int cip = 4 * p.ci4;

  const float* dy_row = p.dy + b * p.ds_b + t * p.ds_t;
  for (int e = threadIdx.x; e < p.Fo * p.co4; e += blockDim.x) {
    const int f = e / p.co4;
    const int c = 4 * (e - f * p.co4);
    stage4(dy_s + f * cop + c, dy_row + f * p.ds_f + c, p.vec_dy, p.co - c);
  }

  for (int e = threadIdx.x; e < p.ndt * p.fpad * p.ci4; e += blockDim.x) {
    const int c4 = e % p.ci4;
    const int q = e / p.ci4;
    const int fp = q % p.fpad;
    const int dtl = q / p.fpad;
    const int c = 4 * c4;
    const int t_in = t + dt0 + dtl - p.pt0;
    const int f_in = fp - p.pf0;
    float* dst = x_s + (dtl * p.fpad + fp) * cip + c;
    if (t_in >= 0 && t_in < p.T && f_in >= 0 && f_in < p.F) {
      stage4(dst, p.x + b * p.xs_b + t_in * p.xs_t + f_in * p.xs_f + c, p.vec_x, p.ci - c);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int kTaps>
__global__ void __launch_bounds__(kMaxThreads)
conv_dw_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cop = 4 * p.co4;
  const int cip = 4 * p.ci4;
  const int dy_floats = p.Fo * cop;
  const int stage_floats = dy_floats + p.ndt * p.fpad * cip;

  const int slice = blockIdx.x;
  const int dt0 = blockIdx.y * p.ndt;
  const int dfc0 = blockIdx.z * p.ndfb;

  // This thread's taps and register tile.
  const int tile = p.ci4 * p.co4;
  const int grp = threadIdx.x / tile;
  const int in_tile = threadIdx.x - grp * tile;
  const int ci_t = in_tile / p.co4;
  const int co_t = in_tile - ci_t * p.co4;
  const int dtl = grp / p.ndfb;
  const int dfc = dfc0 + (grp - dtl * p.ndfb);
  const bool active = dtl < p.ndt && dfc < p.ndfc;

  float acc[kTaps][4][4];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][i][j] = 0.f;

  const int r0 = slice * p.rows_per_slice;
  const int r1 = min(p.rows, r0 + p.rows_per_slice);

  if (r0 < r1) stage_row(p, r0, dt0, smem, smem + dy_floats);
  __pipeline_commit();
  for (int r = r0; r < r1; ++r) {
    float* cur = smem + ((r - r0) & 1) * stage_floats;
    float* nxt = smem + ((r - r0 + 1) & 1) * stage_floats;
    if (r + 1 < r1) stage_row(p, r + 1, dt0, nxt, nxt + dy_floats);
    __pipeline_commit();
    __pipeline_wait_prior(1);          // row r has landed; row r + 1 may be in flight
    __syncthreads();

    if (active) {
      const float4* dy4 = reinterpret_cast<const float4*>(cur) + co_t;
      const float4* x4 = reinterpret_cast<const float4*>(cur + dy_floats) +
                         (size_t)(dtl * p.fpad + dfc * kTaps) * p.ci4 + ci_t;
      const int x_step = p.sf * p.ci4;
      for (int f = 0; f < p.Fo; ++f) {
        const float4 d = dy4[f * p.co4];
        const float4* xr = x4 + f * x_step;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const float4 xv = xr[k * p.ci4];
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[k][i][0] = fmaf(xa[i], d.x, acc[k][i][0]);
            acc[k][i][1] = fmaf(xa[i], d.y, acc[k][i][1]);
            acc[k][i][2] = fmaf(xa[i], d.z, acc[k][i][2]);
            acc[k][i][3] = fmaf(xa[i], d.w, acc[k][i][3]);
          }
        }
      }
    }
    __syncthreads();                   // cur is staged again two rows on
  }

  if (!active) return;
  const int dt = dt0 + dtl;
  if (dt >= p.kt) return;
  float* out = p.part + ((size_t)slice * p.kt + dt) * p.kf * p.ci * p.co;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int df = dfc * kTaps + k;
    if (df >= p.kf) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c_in = 4 * ci_t + i;
      if (c_in >= p.ci) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c_out = 4 * co_t + j;
        if (c_out < p.co)
          out[((size_t)df * p.ci + c_in) * p.co + c_out] = acc[k][i][j];
      }
    }
  }
}

// dw[e] = part[0][e] + part[1][e] + ... in this order.
__global__ void conv_dw_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dw, int n, int slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[(size_t)s * n + e];
  dw[e] = acc;
}

// How the taps are spread over a block and the grid.
struct Plan {
  int taps;        // kTaps: 5, 6 or 7, whichever pads kf least (the larger on a tie)
  int ndfc;        // chunks of `taps` frequency taps: ceil(kf / taps)
  int ndfb, ndt;   // chunks and time taps per block
  int grid_y, grid_z;
  int threads;
};

bool make_plan(int kt, int kf, int ci, int co, Plan* plan) {
  const int tile = ((ci + 3) / 4) * ((co + 3) / 4);
  if (kt < 1 || kf < 1 || ci < 1 || co < 1 || tile > kMaxThreads) return false;
  int taps = 5;
  for (int k = 6; k <= 7; ++k)
    if ((kf + k - 1) / k * k <= (kf + taps - 1) / taps * taps) taps = k;
  const int groups = kMaxThreads / tile;
  plan->taps = taps;
  plan->ndfc = (kf + taps - 1) / taps;
  plan->ndfb = plan->ndfc < groups ? plan->ndfc : groups;
  plan->grid_z = (plan->ndfc + plan->ndfb - 1) / plan->ndfb;
  int ndt = groups / plan->ndfb;
  if (ndt > kt) ndt = kt;
  plan->grid_y = (kt + ndt - 1) / ndt;
  plan->ndt = (kt + plan->grid_y - 1) / plan->grid_y;   // even shares
  plan->threads = ((plan->ndt * plan->ndfb * tile + 31) / 32) * 32;
  return true;
}

// Positions of a staged x row, and the dynamic shared memory of a block: two
// stages of one dy row and `ndt` x rows, channels padded to multiples of 4.
int staged_positions(const Plan& plan, int Fo, int sf) {
  return sf * (Fo - 1) + plan.ndfc * plan.taps;
}

size_t stage_bytes(const Plan& plan, int Fo, int ci, int co, int sf) {
  const size_t ci4 = (ci + 3) / 4, co4 = (co + 3) / 4;
  return 2 * sizeof(float) * ((size_t)Fo * 4 * co4 +
                              (size_t)plan.ndt * staged_positions(plan, Fo, sf) * 4 * ci4);
}

template <int kTaps>
int launch(const Params& p, const Plan& plan, int slices, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_dw_kernel<kTaps>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(slices, plan.grid_y, plan.grid_z);
  conv_dw_kernel<kTaps><<<grid, plan.threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int reduce_slices(const float* part, float* dw, int n, int slices, cudaStream_t stream) {
  conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, slices);
  return (int)cudaGetLastError();
}

// ------------------------------------- tensor cores: bf16 "mma", f32 "bf16x3"

constexpr int kMmaWarps = 8;       // warps that multiply (two warpgroups)
constexpr int kStageThreads = 128; // threads that stage (a warpgroup)
constexpr int kThreads = 32 * kMmaWarps + kStageThreads;
constexpr int kFlushRows = 128;    // dy rows a warp's running sums span, about

// What the plane count P sets: the input type; registers a thread of each
// role (setmaxnreg; at most 64K a block; the launch gives each of its 384
// threads 168, the budget ptxas allocates the whole kernel in); whether the
// x planes share one tail a stage (kSharedTail; mma_geometry); whether a
// prefetched group of x fragments is one m16 row of a tap (kRowGroups) or
// all of the tap's; and the buffers of dy's fragments (kDyBuffers: with two
// the next step's load while the last group's products run).
template <int P>
struct Planes;
template <>
struct Planes<1> {
  using T = __nv_bfloat16;
  static constexpr int kStageRegs = 40, kMmaRegs = 232;
  static constexpr bool kSharedTail = false;
  static constexpr bool kRowGroups = false;
  static constexpr int kDyBuffers = 2;
};
template <>
struct Planes<3> {
  using T = float;
  static constexpr int kStageRegs = 56, kMmaRegs = 224;
  static constexpr bool kSharedTail = true;
  static constexpr bool kRowGroups = true;
  static constexpr int kDyBuffers = 1;
};

// Taps a warp: 128 f32 accumulators a thread over its MT x NT tiles at one
// plane, 64 at three (whose fragments take the registers of the rest).
__host__ __device__ constexpr int mma_units(int cx, int cd, int planes) {
  return 32 / ((cx == 4 ? 2 : 1) * (cd == 4 ? 4 : 2)) / (planes == 1 ? 1 : 2);
}

// The products of a k16 step and tap, smallest first: (x plane, dy plane)
// of product e.  One plane: x d.  Three: x0 d2, x1 d1, x2 d0 (order 2^-16 of
// x d), x0 d1, x1 d0 (2^-8), x0 d0, so that the small terms are summed
// before the large one joins them; x1 d2, x2 d1 and x2 d2 (order 2^-24) are
// left out.
__host__ __device__ constexpr int product_x(int planes, int e) {
  return planes == 1 ? 0 : (e < 3 ? e : (e == 4 ? 1 : 0));
}
__host__ __device__ constexpr int product_dy(int planes, int e) {
  return planes == 1 ? 0 : (e < 3 ? 2 - e : (e == 3 ? 1 : 0));
}

// Switch-offs that time a part of the tensor-core kernel by its absence
// (built with -DAAS_DW_SKIP_...; the results are wrong then): STAGE stages
// only the first two windows of a slice, MMA runs no product (the fragments
// are still loaded), LOAD loads no fragment (the products run on zeros).
#ifdef AAS_DW_SKIP_STAGE
constexpr bool kStage = false;
#else
constexpr bool kStage = true;
#endif
#ifdef AAS_DW_SKIP_MMA
constexpr bool kMma = false;
#else
constexpr bool kMma = true;
#endif
#ifdef AAS_DW_SKIP_LOAD
constexpr bool kLoad = false;
#else
constexpr bool kLoad = true;
#endif

struct MmaParams {
  const void* x;                // bf16 (one plane) or f32 (three)
  const void* dy;
  float* part;
  long long xs_b, xs_t, xs_f;   // x strides in elements (channel stride 1)
  long long ds_b, ds_t, ds_f;   // dy strides in elements (channel stride 1)
  int T, F, Fo, ci, co, kt, kf, sf, pt0, pf0;
  int rows;                     // B * T
  int rows_per_slice;
  int nco;                      // co chunks (grid y = ci chunks x nco x groups)
  int groups;                   // tap groups a channel chunk pair
  int per_block;                // taps a block (the last group may hold fewer)
  int win;                      // dy rows a window, at most
  int ndt;                      // time taps a block's taps span, at most
  int half;                     // staged positions of one phase: Fo + (kf - 1) / sf
  int xp;                       // staged rows of one x time slot (mma_geometry)
  int tail;                     // x rows staged past a window's n + ndt - 1 slots
  int vec_x, vec_dy;            // 16-byte copies allowed (strides and base)
};

// Byte offset of 16-byte chunk c of staged row r, rows of C chunks (C = 1,
// 2 or 4: 16, 32 or 64 bytes).  The chunk is XORed with h(r) = (r / (8 / C))
// mod C, so the same chunk of any 8 consecutive rows lies in 8 distinct
// 16-byte bank groups of the 128-byte line.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kShift = C == 4 ? 1 : (C == 2 ? 2 : 3);   // log2(8 / C)
  return r * 16 * C + 16 * (c ^ ((r >> kShift) & (C - 1)));
}

__device__ __forceinline__ void zero16(char* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Eight bf16 channels of a row into 16 bytes of shared memory, zero past the
// first `n`: one 16-byte cp.async (`vec` and all eight there), or scalar loads.
__device__ __forceinline__ void stage8(char* dst, const __nv_bfloat16* src, bool vec, int n) {
  if (vec && n >= 8) {
    __pipeline_memcpy_async(dst, src, 16);
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = 2 * k < n ? __ldg(s + 2 * k) : 0u;
    const unsigned hi = 2 * k + 1 < n ? __ldg(s + 2 * k + 1) : 0u;
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  union {
    __nv_bfloat162 h;
    unsigned u;
  } c;
  c.h = h;
  return c.u;
}

// Eight f32 channels v split into three bf16 planes, each 16 bytes at dst +
// q plane: v0 = bf16_rn(v), v1 = bf16_rn(v - v0), v2 = bf16_rn(v - v0 - v1),
// the subtractions exact in f32, so that v0 + v1 + v2 holds all 24 bits of
// v's significand (ops/cuda/conv_dw.py::split3_bf16 is the same on the CPU).
__device__ __forceinline__ void split8(char* dst, int plane, const float (&v)[8]) {
  unsigned w0[4], w1[4], w2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 f0 = __bfloat1622float2(h0);
    const float r0 = v[2 * i] - f0.x, r1 = v[2 * i + 1] - f0.y;
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(r0, r1);
    const float2 f1 = __bfloat1622float2(h1);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(r0 - f1.x, r1 - f1.y);
    w0[i] = bf16x2_bits(h0);
    w1[i] = bf16x2_bits(h1);
    w2[i] = bf16x2_bits(h2);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w0[0], w0[1], w0[2], w0[3]);
  *reinterpret_cast<uint4*>(dst + plane) = make_uint4(w1[0], w1[1], w1[2], w1[3]);
  *reinterpret_cast<uint4*>(dst + 2 * plane) = make_uint4(w2[0], w2[1], w2[2], w2[3]);
}

// Eight f32 channels of a row, zero past the first `n`, split into the three
// planes now (two 16-byte loads where `vec` and all eight are there).
__device__ __forceinline__ void split_now(char* dst, int plane, const float* src, bool vec,
                                          int n) {
  float v[8];
  if (vec && n >= 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < n ? __ldg(src + k) : 0.f;
  }
  split8(dst, plane, v);
}

// The window of n dy rows from flattened row r (one utterance b), staged:
// dy_s holds positions k = i Fo + f (row i of the window, bin f) for k <
// ceil16(n Fo), zero past n Fo; x_s holds n + ndt - 1 time slots and `tail`
// rows, slot j = x time t + dt_min - pt0 + j, each of xp rows, row ph half +
// jj = frequency sf jj + ph - pf0 (sf is 1 or 2; rows from sf half on are
// never read), zero outside [0, T) x [0, F).  Rows of CX (x) and CD (dy)
// chunks of 8 channels from ci0 and co0, zero past ci, co; P planes of them,
// plane q of dy at dy_s + q dy_plane bytes, of x at x_s + q x_plane.  A
// thread of the staging warpgroup keeps one chunk and walks every (128 /
// C)-th row, dy's then x's, with running indices (a row step is split once
// into whole rows or slots and a rest, so that a row costs no division).
template <int CX, int CD, int P>
struct Stager {
  using T = typename Planes<P>::T;
  static constexpr int kStepD = kStageThreads / CD;   // rows a pass of the staging warps
  static constexpr int kStepX = kStageThreads / CX;
  const T* dy;               // this thread's chunk of dy[b, t]
  const T* x;                // and of x[b]
  char* dy_s;
  char* x_s;
  int cd, cx;                // the thread's chunks
  int nd, nx;                // and their channels that exist (8 or more: all)
  int kn, k_end, k, f;       // dy: positions n Fo, ceil16(n Fo); this row, its bin
  long long d_off;           // its offset in dy
  int q_end, q, slot, w, t_x;   // x: rows, this row, its slot and row in the slot

  __device__ Stager(const MmaParams& p, int tid, int r, int n, int dt_min, int ci0, int co0,
                    char* dy_s_, char* x_s_)
      : dy_s(dy_s_), x_s(x_s_) {
    const int b = r / p.T;
    const int t = r - b * p.T;
    cd = tid % CD;
    cx = tid % CX;
    nd = p.co - co0 - 8 * cd;
    nx = p.ci - ci0 - 8 * cx;
    dy = static_cast<const T*>(p.dy) + b * p.ds_b + t * p.ds_t + co0 + 8 * cd;
    x = static_cast<const T*>(p.x) + b * p.xs_b + ci0 + 8 * cx;
    kn = n * p.Fo;
    k_end = n > 0 ? (kn + 15) & ~15 : 0;
    k = tid / CD;
    const int i = k / p.Fo;
    f = k - i * p.Fo;
    d_off = i * p.ds_t + f * p.ds_f;
    q_end = n > 0 ? (n + p.ndt - 1) * p.xp + (Planes<P>::kSharedTail ? 0 : p.tail) : 0;
    q = tid / CX;
    slot = q / p.xp;
    w = q - slot * p.xp;
    t_x = t + dt_min - p.pt0;
  }

  // unit(dst, src, n, vec, is_x) for each of this thread's rows: dst its
  // chunk in plane 0, src its channels (nullptr where the row is zero).

  template <class Unit>
  __device__ __forceinline__ void walk(const MmaParams& p, Unit&& unit) {
    const int di = kStepD / p.Fo, df = kStepD - di * p.Fo;
    for (; k < k_end; k += kStepD) {
      unit(dy_s + swz<CD>(k, cd), k < kn ? dy + d_off : nullptr, nd, p.vec_dy, false);
      f += df;
      d_off += di * p.ds_t + df * p.ds_f;
      if (f >= p.Fo) {
        f -= p.Fo;
        d_off += p.ds_t - p.Fo * p.ds_f;
      }
    }
    const int ds = kStepX / p.xp, dw = kStepX - ds * p.xp;
    for (; q < q_end; q += kStepX) {
      if (w < p.sf * p.half) {           // rows past sf half are never read
        const int ph = w >= p.half;
        const int t_in = t_x + slot;
        const int f_in = p.sf * (w - ph * p.half) + ph - p.pf0;
        const bool in = t_in >= 0 && t_in < p.T && f_in >= 0 && f_in < p.F;
        unit(x_s + swz<CX>(q, cx), in ? x + t_in * p.xs_t + f_in * p.xs_f : nullptr, nx,
             p.vec_x, true);
      }
      slot += ds;
      w += dw;
      if (w >= p.xp) {
        w -= p.xp;
        ++slot;
      }
    }
  }
};

// Stage the window of n dy rows from row r into one stage (its P planes of
// dy from buf, of x from buf + P dy_plane), and wait for its copies.  bf16:
// each 16-byte chunk by cp.async.  f32: each chunk's eight floats loaded
// into registers (two 16-byte loads where allowed), split, and stored to its
// three planes (zeros where the row is zero).
template <int CX, int CD, int P>
__device__ __forceinline__ void stage_window(const MmaParams& p, int r, int n, int dt_min,
                                             int ci0, int co0, char* buf, int dy_plane,
                                             int x_plane) {
  char* dy_s = buf;
  char* x_s = buf + P * dy_plane;
  Stager<CX, CD, P> st(p, threadIdx.x, r, n, dt_min, ci0, co0, dy_s, x_s);
  if constexpr (P == 1) {
    st.walk(p, [&](char* dst, const __nv_bfloat16* src, int c, int vec, bool) {
      if (src) stage8(dst, src, vec, c);
      else zero16(dst);
    });
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    st.walk(p, [&](char* dst, const float* src, int c, int vec, bool is_x) {
      const int plane = is_x ? x_plane : dy_plane;
      if (src) {
        split_now(dst, plane, src, vec, c);
      } else {
        zero16(dst);
        zero16(dst + plane);
        zero16(dst + 2 * plane);
      }
    });
  }
}

// Named barriers between the staging warps and the multiplying warps, each
// counting all n threads of the block: kFull + s, stage s holds its window;
// kEmpty + s, stage s may be staged again.  (0 is __syncthreads'.)
constexpr int kFull = 1, kEmpty = 3;

template <int n>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(n) : "memory");
}

template <int n>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(n) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void more_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void fewer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Four 8 x 8 bf16 matrices, transposed, from the shared-memory rows whose
// addresses the lanes give (lanes 8 q to 8 q + 7: matrix q).
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b for one m16n8k16 tile: bf16 products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CX, CD: 16-byte chunks (8 channels) of a staged x and dy row, 1, 2 or 4.
// A warp's tile is MT m16 tiles of ci (2 where CX = 4) by NT n8 tiles of co
// (4 where CD = 4); where a staged row holds 8 channels (CX or CD = 1), the
// lanes that address the upper 8 read a zero row.  P: bf16 planes of a
// value, 1 (bf16 x and dy) or 3 (f32 x and dy, split as they are staged).
template <int CX, int CD, int P>
__global__ void __launch_bounds__(kThreads, 1)
conv_dw_mma_kernel(const MmaParams p) {
  constexpr int MT = CX == 4 ? 2 : 1;
  constexpr int NT = CD == 4 ? 4 : 2;
  constexpr int U = mma_units(CX, CD, P);   // taps a warp
  constexpr int kProducts = P == 1 ? 1 : 6;
  extern __shared__ uint4 smem_mma[];
  char* smem = reinterpret_cast<char*>(smem_mma);
  constexpr bool kShared = Planes<P>::kSharedTail;
  const int dy_plane = (((p.win * p.Fo + 15) & ~15) + (kShared ? 0 : 16)) * 16 * CD;
  const int x_plane = ((p.win + p.ndt - 1) * p.xp + (kShared ? 0 : p.tail)) * 16 * CX;
  const int stage = P * (dy_plane + x_plane) + (kShared ? p.tail * 16 * CX : 0);
  char* zero_row = smem + 2 * stage;
  if (kShared) {   // the tails, and rows no window stages, read as zeros
    for (int e = threadIdx.x; e < 2 * stage / 16; e += kThreads)
      zero16(smem + 16 * e);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x;
  const int pair = blockIdx.y / p.groups;
  const int g = blockIdx.y - pair * p.groups;
  const int ci0 = (pair / p.nco) * 8 * CX;
  const int co0 = (pair % p.nco) * 8 * CD;
  const int ntaps = p.kt * p.kf;
  const int tap0 = g * p.per_block;
  const int tap1 = min(ntaps, tap0 + p.per_block);
  const int dt_min = tap0 / p.kf;
  const int r0 = slice * p.rows_per_slice;
  const int r1 = min(p.rows, r0 + p.rows_per_slice);
  auto window = [&](int r) { return min(min(p.win, r1 - r), p.T - r % p.T); };

  // Window it is in stage it % 2.  The staging warpgroup stages the windows
  // in turn, each into a stage the multiplying warps are done with, so that
  // their loads never wait on its copies and its copies never on their
  // products.
  constexpr int kAll = kThreads;
  if (threadIdx.x < kStageThreads) {
    fewer_registers<Planes<P>::kStageRegs>();
    int it = 0;
    for (int r = r0; r < r1; ++it) {
      const int n = window(r);
      const int s = it & 1;
      if (it >= 2) bar_sync<kAll>(kEmpty + s);
      if (kStage || it < 2)
        stage_window<CX, CD, P>(p, r, n, dt_min, ci0, co0, smem + s * stage, dy_plane, x_plane);
      __threadfence_block();
      bar_arrive<kAll>(kFull + s);
      r += n;
    }
    return;
  }
  more_registers<Planes<P>::kMmaRegs>();
  if (threadIdx.x == kStageThreads) zero16(zero_row);   // read after the first kFull
  const int wtap0 = tap0 + (warp - kStageThreads / 32) * U;
  const int nu = max(0, min(U, tap1 - wtap0));   // this warp's taps

  // Staged x row of each tap at bin 0 of window row 0: its time slot, its
  // phase and its shift within the phase.  A warp with fewer than U taps
  // (nu) multiplies its last tap again in place of the rest, on rows its
  // block staged, and never stores those sums.
  int off[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int tap = min(wtap0 + u, tap1 - 1);
    const int dt = tap / p.kf;
    const int df = tap - dt * p.kf;
    off[u] = (dt - dt_min) * p.xp + (df % p.sf) * p.half + df / p.sf;
  }

  float acc[U][MT][NT][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][m][j][v] = 0.f;

  // Accumulator v of tile (m, j): ci row 16 m + lane / 4 (+ 8 for v >= 2),
  // co column 8 j + 2 (lane % 4) + v % 2.  The warp's sums go to part[slice]
  // every kFlushRows dy rows or so (stored the first time, added after) and
  // restart from zero, so that no running sum spans more than that whatever
  // the batch (the tensor cores' f32 sums do not round to nearest; their
  // error grows with the run).
  const int rg = lane >> 2;
  const int cg = 2 * (lane & 3);
  auto flush = [&](bool first) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      float* out = p.part + ((size_t)slice * ntaps + wtap0 + u) * p.ci * p.co;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // A tile's four sums: their loads issue before their stores, so
          // that they wait once, not once each.
          auto at = [&](int v) {   // the sum's offset in out; -1: no such channel
            const int c_in = ci0 + 16 * m + rg + 8 * (v >> 1);
            const int c_out = co0 + 8 * j + cg + (v & 1);
            return c_in < min(p.ci, ci0 + 8 * CX) && c_out < min(p.co, co0 + 8 * CD)
                       ? c_in * p.co + c_out : -1;
          };
          float sum[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            sum[v] = !first && at(v) >= 0 ? out[at(v)] + acc[u][m][j][v] : acc[u][m][j][v];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (at(v) >= 0) out[at(v)] = sum[v];
            acc[u][m][j][v] = 0.f;
          }
        }
    }
  };

  // The lane's row of ldmatrix's four 8 x 8 matrices.  x (the A operand):
  // position lk of the step's 16 (matrices 2, 3: the upper 8), chunk lc of a
  // 16-channel pair, so that the registers come out as a0..a3.  dy (B):
  // position lkd (matrices 1, 3: the upper 8), chunk lcd of the pair, so that
  // each n8 tile's b0, b1 come out in adjacent registers, as the product
  // takes them.  Lanes that would address channels past an 8-channel row
  // read the zero row instead and never move (zx, zd), in every plane.
  const int lk = (lane & 7) + ((lane >> 4) << 3);
  const int lc = (lane >> 3) & 1;
  const int lkd = (lane & 7) + (lc << 3);
  const int lcd = lane >> 4;
  const bool zx = CX == 1 && lc;
  const bool zd = CD == 1 && lcd;
  const unsigned zero_addr = (unsigned)__cvta_generic_to_shared(zero_row);
  const unsigned smem_addr = (unsigned)__cvta_generic_to_shared(smem);
  // A step moves every lane 16 positions on: 16 rows of dy and of x, and
  // where the lane passes the end of a dy row, xp - Fo more rows of x.  Both
  // are multiples of 8 rows (xp = Fo mod 8), so the chunk XOR of each row a
  // lane reads stays the same all window long.  A plane is a fixed offset
  // (d_pl, x_pl) from the lane's row in plane 0.
  const int d_step = zd ? 0 : 16 * 16 * CD;
  const int x_step = zx ? 0 : 16 * 16 * CX;
  const int x_wrap = zx ? 0 : (p.xp - p.Fo) * 16 * CX;
  const int d_pl = zd ? 0 : dy_plane;
  const int x_pl = zx ? 0 : x_plane;

  int it = 0;
  int since = 0;                       // dy rows in the sums since the last flush
  bool first = true;
  for (int r = r0; r < r1; ++it) {
    const int n = window(r);
    const int cur = (it & 1) * stage;
    bar_sync<kAll>(kFull + (it & 1));

    if (nu > 0) {
      // The lane's position (window row i, bin f), its dy row k = lkd and x
      // row xrow at tap offset 0; the addresses it reads, as a moving base
      // (d_cur, x_cur) plus a fixed part for each fragment (dk, xk).
      int f = lk % p.Fo;
      const int xrow = (lk / p.Fo) * p.xp + f;
      unsigned d_cur = zd ? zero_addr : smem_addr + cur + lkd * 16 * CD;
      unsigned x_cur = zx ? zero_addr : smem_addr + cur + P * dy_plane + xrow * 16 * CX;
      int dk[NT / 2];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) dk[j] = zd ? 0 : swz<CD>(lkd, 2 * j + lcd) - lkd * 16 * CD;
      int xk[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xk[u][m] = zx ? 0 : swz<CX>(xrow + off[u], 2 * m + lc) - xrow * 16 * CX;
      auto load_dy = [&](unsigned (&b)[P][NT / 2][4]) {
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            if (kLoad) ldsm_x4_trans(b[q][j], d_cur + dk[j] + q * d_pl);
            else b[q][j][0] = b[q][j][1] = b[q][j][2] = b[q][j][3] = 0u;
      };
      const bool one_end = p.Fo >= 16;
      auto advance = [&]() {
        f += 16;
        if (one_end) {                 // at most one row end: no branch
          const bool wrap = f >= p.Fo;
          f = wrap ? f - p.Fo : f;
          x_cur += wrap ? x_wrap : 0;
        } else {
          while (f >= p.Fo) {
            f -= p.Fo;
            x_cur += x_wrap;
          }
        }
        x_cur += x_step;
        d_cur += d_step;
      };
      // Fragment groups, in the order their products run: a group is G m16
      // rows of x fragments of one tap (all MT of them, or one), its P
      // planes of each.
      constexpr int G = Planes<P>::kRowGroups ? 1 : MT;
      constexpr int NG = U * (MT / G);
      auto load_x = [&](unsigned (&a)[P][G][4], int v) {
        const int u = v / (MT / G), m0 = v % (MT / G) * G;
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int m = 0; m < G; ++m)
            if (kLoad) ldsm_x4_trans(a[q][m], x_cur + xk[u][m0 + m] + q * x_pl);
            else a[q][m][0] = a[q][m][1] = a[q][m][2] = a[q][m][3] = 0u;
      };
      // One plane: the products go straight into the running sums.  Three:
      // the six are summed from zero in a tile of their own, smallest first
      // (so that the tensor cores' truncation is relative to a 16-position
      // sum), then added to the running sums by f32 adds, rounded to nearest.
      auto products = [&](int v, const unsigned (&a)[P][G][4], const unsigned (&b)[P][NT / 2][4]) {
        if (!kMma) return;
        const int u = v / (MT / G), m0 = v % (MT / G) * G;
#pragma unroll
        for (int m = 0; m < G; ++m) {
          float (&c)[NT][4] = acc[u][m0 + m];
          float t[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[j][e] = P == 1 ? c[j][e] : 0.f;
#pragma unroll
          for (int e = 0; e < kProducts; ++e) {
            const int qx = product_x(P, e), qd = product_dy(P, e);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(t[j], a[qx][m], b[qd][j / 2][2 * (j % 2)], b[qd][j / 2][2 * (j % 2) + 1]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[j][e] = P == 1 ? t[j][e] : c[j][e] + t[j][e];
        }
      };
      // Positions past the window's hold zero dy (x there is staged, and
      // finite); the last step's loads of the step after it read rows inside
      // the stage and go unused.
      const int k_end = (n * p.Fo + 15) & ~15;
      // Group v + 1's x fragments load while group v's products run.  With
      // two dy buffers (one plane) the next step's dy and first x fragments
      // load while the last group's products run, dy's buffers in turn; with
      // one (three planes: 24 registers each) after them.
      constexpr int D = Planes<P>::kDyBuffers;
      static_assert(D == 1 || NG % 2 == 0, "the next step's first group takes buffer 0");
      unsigned bf[D][P][NT / 2][4], af[2][P][G][4];
      auto step = [&](const unsigned (&b)[P][NT / 2][4], unsigned (&b_next)[P][NT / 2][4]) {
#pragma unroll
        for (int v = 0; v < NG; ++v) {
          if (v + 1 < NG) {
            load_x(af[(v + 1) & 1], v + 1);
          } else if (D == 2) {
            advance();
            load_dy(b_next);
            load_x(af[0], 0);
          }
          products(v, af[v & 1], b);
        }
        if (D == 1) {
          advance();
          load_dy(b_next);
          load_x(af[0], 0);
        }
      };
      load_dy(bf[0]);
      load_x(af[0], 0);
      for (int k0 = 0; k0 < k_end; k0 += 32) {   // two steps
        step(bf[0], bf[D - 1]);
        if (k0 + 16 < k_end) step(bf[D - 1], bf[0]);
      }
    }
    since += n;
    if (since >= kFlushRows && r + n < r1) {
      flush(first);
      first = false;
      since = 0;
    }
    bar_arrive<kAll>(kEmpty + (it & 1));   // cur may be staged again
    r += n;
  }
  flush(first);
}

// The x slot pitch and tail of the tensor-core kernel
// (ops/cuda/conv_dw.py::mma_geometry): xp >= sf half rows with xp = Fo mod
// 8; `tail` rows past a window's n + ndt - 1 slots, so that the positions of
// its last step and of the step after it (prefetched, unused), up to n Fo +
// 30, fall on rows of finite values: at one plane staged rows of each plane
// (and 16 dy rows past a window's), at three (kSharedTail) the next plane's
// rows and one zeroed tail a stage after the last x plane: those positions'
// dy is zero, and the fragments past the last step are never used.
void mma_geometry(int Fo, int kf, int sf, int* half, int* xp, int* tail) {
  *half = Fo + (kf - 1) / sf;
  *xp = sf * *half + (((Fo - sf * *half) % 8) + 8) % 8;
  *tail = (30 / Fo) * *xp + (sf - 1) * *half + 30 % Fo + (kf - 1) / sf + 1;
}

// Two stages of a window (each P planes of dy rows and of x rows, and at
// three planes the shared tail) and the zero row.
size_t mma_stage_bytes(int planes, int cx, int cd, int win, int ndt, int Fo, int kf, int sf) {
  int half, xp, tail;
  mma_geometry(Fo, kf, sf, &half, &xp, &tail);
  const size_t dy_rows = (win * Fo + 15) & ~15, x_rows = (size_t)(win + ndt - 1) * xp;
  if (planes == 1) return 2 * ((dy_rows + 16) * 16 * cd + (x_rows + tail) * 16 * cx) + 16;
  return 2 * (planes * (dy_rows * 16 * cd + x_rows * 16 * cx) + (size_t)tail * 16 * cx) + 16;
}

template <int CX, int CD, int P>
int launch_mma(const MmaParams& p, int grid_y, int slices, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_dw_mma_kernel<CX, CD, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  conv_dw_mma_kernel<CX, CD, P><<<dim3(slices, grid_y), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int CX, int P>
int launch_mma_cd(const MmaParams& p, int cd, int grid_y, int slices, size_t smem,
                  cudaStream_t stream) {
  if (cd == 1) return launch_mma<CX, 1, P>(p, grid_y, slices, smem, stream);
  if (cd == 2) return launch_mma<CX, 2, P>(p, grid_y, slices, smem, stream);
  return launch_mma<CX, 4, P>(p, grid_y, slices, smem, stream);
}

template <int P>
int launch_mma_cx(const MmaParams& p, int cx, int cd, int grid_y, int slices, size_t smem,
                  cudaStream_t stream) {
  if (cx == 1) return launch_mma_cd<1, P>(p, cd, grid_y, slices, smem, stream);
  if (cx == 2) return launch_mma_cd<2, P>(p, cd, grid_y, slices, smem, stream);
  return launch_mma_cd<4, P>(p, cd, grid_y, slices, smem, stream);
}

}  // namespace

// Slices of the (b, t) rows the f32 launch below wants for `rows` = B * T
// rows of Fo output bins on a card with `sms` multiprocessors (about two
// blocks per SM); 0 if the kernel does not take the shape (a ci x co tile of
// more than kMaxThreads threads, or staged rows beyond a block's shared
// memory).  ops/cuda/conv_dw.py::conv_dw_plan computes the same in Python
// (the GPU tests hold the two together).
extern "C" int aas_conv_dw_slices(int rows, int Fo, int kt, int kf, int ci,
                                  int co, int sf, int sms) {
  Plan plan;
  if (rows < 1 || Fo < 1 || sf < 1 || sms < 1 || !make_plan(kt, kf, ci, co, &plan) ||
      stage_bytes(plan, Fo, ci, co, sf) > kMaxStageBytes)
    return 0;
  const int blocks = plan.grid_y * plan.grid_z;
  int slices = (2 * sms + blocks - 1) / blocks;
  if (slices > rows) slices = rows;
  return slices < 1 ? 1 : slices;
}

int launch_taps(const Params& p, const Plan& plan, int slices, size_t smem,
                cudaStream_t stream) {
  if (plan.taps == 5) return launch<5>(p, plan, slices, smem, stream);
  if (plan.taps == 6) return launch<6>(p, plan, slices, smem, stream);
  return launch<7>(p, plan, slices, smem, stream);
}

// f32 x and dy ("fma"); part and dw are f32.
extern "C" int aas_conv_dw(const float* x, const float* dy, float* part,
                           float* dw, long long xs_b, long long xs_t,
                           long long xs_f, long long ds_b, long long ds_t,
                           long long ds_f, int B, int T, int F, int Fo, int ci,
                           int co, int kt, int kf, int sf, int pt0, int pf0,
                           int slices, cudaStream_t stream) {
  Plan plan;
  if (B < 1 || T < 1 || slices < 1 || sf < 1 || !make_plan(kt, kf, ci, co, &plan))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dy = dy;
  p.part = part;
  p.xs_b = xs_b; p.xs_t = xs_t; p.xs_f = xs_f;
  p.ds_b = ds_b; p.ds_t = ds_t; p.ds_f = ds_f;
  p.T = T; p.F = F; p.Fo = Fo; p.ci = ci; p.co = co;
  p.kt = kt; p.kf = kf; p.sf = sf; p.pt0 = pt0; p.pf0 = pf0;
  p.rows = B * T;
  p.rows_per_slice = (p.rows + slices - 1) / slices;
  p.ci4 = (ci + 3) / 4;
  p.co4 = (co + 3) / 4;
  p.ndt = plan.ndt;
  p.ndfc = plan.ndfc;
  p.ndfb = plan.ndfb;
  p.fpad = staged_positions(plan, Fo, sf);
  p.vec_x = ci % 4 == 0 && xs_b % 4 == 0 && xs_t % 4 == 0 && xs_f % 4 == 0 &&
            reinterpret_cast<size_t>(x) % 16 == 0;
  p.vec_dy = co % 4 == 0 && ds_b % 4 == 0 && ds_t % 4 == 0 && ds_f % 4 == 0 &&
             reinterpret_cast<size_t>(dy) % 16 == 0;
  const size_t smem = stage_bytes(plan, Fo, ci, co, sf);
  if (smem > kMaxStageBytes) return (int)cudaErrorInvalidValue;

  const int err = launch_taps(p, plan, slices, smem, stream);
  if (err != 0) return err;
  return reduce_slices(part, dw, kt * kf * ci * co, slices, stream);
}

// bf16 x and dy ("mma", planes = 1) or f32 x and dy ("bf16x3", planes = 3,
// each value split into three bf16 planes as it is staged); part and dw are
// f32.  The tiling is the plan's (ops/cuda/conv_dw.py::conv_dw_plan): cx, cd
// chunks of 8 channels in a staged x and dy row (1, 2 or 4; ci and co taken
// in chunks of 8 cx and 8 cd channels), `groups` tap groups of `per_block`
// taps for each channel chunk pair, windows of `win` dy rows, `ndt` time
// taps a block at most, `slices` row slices and `smem` bytes, which must be
// what the kernel needs for that tiling.
extern "C" int aas_conv_dw_mma(const void* x, const void* dy, float* part, float* dw,
                               long long xs_b, long long xs_t, long long xs_f, long long ds_b,
                               long long ds_t, long long ds_f, int B, int T, int F, int Fo,
                               int ci, int co, int kt, int kf, int sf, int pt0, int pf0,
                               int planes, int cx, int cd, int groups, int per_block, int win,
                               int ndt, int slices, long long smem, cudaStream_t stream) {
  if (B < 1 || T < 1 || F < 1 || Fo < 1 || ci < 1 || co < 1 || kt < 1 || kf < 1 || sf < 1 ||
      slices < 1 || groups < 1 || per_block < 1 || win < 1 || ndt < 1 ||
      (planes != 1 && planes != 3) || (cx != 1 && cx != 2 && cx != 4) ||
      (cd != 1 && cd != 2 && cd != 4))
    return (int)cudaErrorInvalidValue;
  if (per_block > mma_units(cx, cd, planes) * kMmaWarps || groups * per_block < kt * kf ||
      (groups - 1) * per_block >= kt * kf ||
      smem != (long long)mma_stage_bytes(planes, cx, cd, win, ndt, Fo, kf, sf) ||
      (size_t)smem > kMaxStageBytes)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < groups; ++g) {   // every block's taps span at most ndt time taps
    const int first = g * per_block;
    const int last = (first + per_block < kt * kf ? first + per_block : kt * kf) - 1;
    if (last / kf - first / kf + 1 > ndt) return (int)cudaErrorInvalidValue;
  }
  MmaParams p;
  p.x = x;
  p.dy = dy;
  p.part = part;
  p.xs_b = xs_b; p.xs_t = xs_t; p.xs_f = xs_f;
  p.ds_b = ds_b; p.ds_t = ds_t; p.ds_f = ds_f;
  p.T = T; p.F = F; p.Fo = Fo; p.ci = ci; p.co = co;
  p.kt = kt; p.kf = kf; p.sf = sf; p.pt0 = pt0; p.pf0 = pf0;
  p.rows = B * T;
  p.rows_per_slice = (p.rows + slices - 1) / slices;
  p.nco = (co + 8 * cd - 1) / (8 * cd);
  p.groups = groups;
  p.per_block = per_block;
  p.win = win;
  p.ndt = ndt;
  mma_geometry(Fo, kf, sf, &p.half, &p.xp, &p.tail);
  const int per16 = planes == 1 ? 8 : 4;   // elements in 16 bytes
  p.vec_x = xs_b % per16 == 0 && xs_t % per16 == 0 && xs_f % per16 == 0 &&
            reinterpret_cast<size_t>(x) % 16 == 0;
  p.vec_dy = ds_b % per16 == 0 && ds_t % per16 == 0 && ds_f % per16 == 0 &&
             reinterpret_cast<size_t>(dy) % 16 == 0;
  const int grid_y = ((ci + 8 * cx - 1) / (8 * cx)) * p.nco * groups;

  const int err = planes == 1 ? launch_mma_cx<1>(p, cx, cd, grid_y, slices, (size_t)smem, stream)
                              : launch_mma_cx<3>(p, cx, cd, grid_y, slices, (size_t)smem, stream);
  if (err != 0) return err;
  return reduce_slices(part, dw, kt * kf * ci * co, slices, stream);
}
