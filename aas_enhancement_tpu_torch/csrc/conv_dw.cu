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
// are index arithmetic on one staged row, and one kernel serves both strides.
//
// Bound on the H100: operations.  At the acoustic model's conv2 (B = 8,
// T = 401, F = 81 -> 41, 32 -> 32 channels, 11 x 21 taps) it is 62 GFLOP on
// 50 MB of input, 0.93 ms at the card's 67 TFLOP/s of f32 FMAs against
// 0.015 ms of memory traffic, so the design keeps the FMA pipes fed from
// registers and shared memory:
// - a block owns `ndt` time taps, a few chunks of kTaps frequency taps and a
//   slice of the (b, t) rows; per row it stages the dy row [Fo, co] and the
//   `ndt` x rows [s (Fo - 1) + taps, ci] it needs (zero where x is padding) in
//   shared memory, double-buffered with cp.async so the next row loads while
//   this one is multiplied;
// - a thread keeps a 4 ci x 4 co register tile for each of its kTaps taps
//   (16 kTaps accumulators); per output position it reads one float4 of dy
//   and kTaps float4 of x from shared memory (the warp's threads share them:
//   broadcasts) for 16 kTaps FMAs;
// - each block writes its partial dW to part[slice]; a second kernel adds the
//   slices in order, so the result does not depend on the schedule: two runs
//   give the same bits.  No atomics.
// TF32 tensor-core products would lift the bound to 0.13 ms; that is later
// work (f32 FMAs keep the gradient within f32 rounding of the plain version).
//
// Layout: x and dy have unit channel stride and strides (b, t, f) in
// elements, so both a contiguous [B, T, F, C] tensor and the channels-last
// memory of an NCHW tensor are read in place.  16-byte loads when the
// channel count and strides are multiples of 4 and the base is aligned, scalar
// loads otherwise; channels are padded to a multiple of 4 in shared memory.
// dW [kt, kf, ci, co] f32, contiguous; part [slices, kt, kf, ci, co].

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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
  int vec_x, vec_dy;            // 16-byte loads allowed
};

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
    float* dst = dy_s + f * cop + c;
    const float* src = dy_row + f * p.ds_f + c;
    if (p.vec_dy) {
      __pipeline_memcpy_async(dst, src, 16);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = c + k < p.co ? __ldg(src + k) : 0.f;
    }
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
      const float* src = p.x + b * p.xs_b + t_in * p.xs_t + f_in * p.xs_f + c;
      if (p.vec_x) {
        __pipeline_memcpy_async(dst, src, 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[k] = c + k < p.ci ? __ldg(src + k) : 0.f;
      }
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

constexpr size_t kMaxStageBytes = 227 * 1024;   // shared memory of one sm_90 block

template <int kTaps>
int launch(const Params& p, const Plan& plan, int slices, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_dw_kernel<kTaps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(slices, plan.grid_y, plan.grid_z);
  conv_dw_kernel<kTaps><<<grid, plan.threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Slices of the (b, t) rows the launch below wants for `rows` = B * T rows of
// Fo output bins on a card with `sms` multiprocessors (about two blocks per
// SM); 0 if the kernel does not take the shape (a ci x co tile of more than
// kMaxThreads threads, or staged rows beyond a block's shared memory).  The
// caller allocates part [slices, kt, kf, ci, co] from it.
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

  int err;
  if (plan.taps == 5) err = launch<5>(p, plan, slices, smem, stream);
  else if (plan.taps == 6) err = launch<6>(p, plan, slices, smem, stream);
  else err = launch<7>(p, plan, slices, smem, stream);
  if (err != 0) return err;

  const int n = kt * kf * ci * co;
  conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, slices);
  return (int)cudaGetLastError();
}
