// The vector-Jacobian products of the STFT and of the ISTFT, each one
// launch: aas_stft_vjp (stft_vjp_kernel) and aas_istft_vjp
// (istft_vjp_kernel), with a direct-sum kernel each for the shapes the radix
// plan does not take.
//
// Replaces: no TPU kernel.  The JAX package differentiates its matmul-DFT
// STFT and ISTFT (aas_enhancement_tpu/dsp/stft.py::stft, ::istft) with
// XLA's autodiff; the port needs them for the paired objective's MR-STFT
// term (train/objectives.py::mr_stft_loss: three STFTs and one ISTFT).
//
// The functions.  The STFT is linear, so its VJP maps (dre, dim) [B, T,
// n_fft/2+1] to dx [B, n]: frame t's gradient is f_t[n] = win[n] sum_k (dre_k
// cos(2 pi n k / N) - dim_k sin(2 pi n k / N)), weight 1 on every bin (the
// real DFT's adjoint: no 1/N, the interior bins not doubled); the frames
// overlap-add into the gradient of the reflect-padded signal, whose
// positions fold back onto the samples they were read from (dx[i] +=
// padded position shift - i for 1 <= i <= shift, and the mirror at the tail;
// the zero tail past the padded signal nowhere).  The ISTFT's VJP maps dy
// [B, L] to (dre, dim): dy placed after the center trim, divided by
// max(sum of window^2, 1e-8), framed, windowed, the real DFT, bin k scaled by
// g_k / N (g = 1 at DC and Nyquist, 2 between).  ops/cuda/stft.py's
// stft_vjp_plain / istft_vjp_plain write these out; stft_vjp_runs_plain and
// istft_vjp_radix_plain follow the kernels below step by step.
//
// Bound on the H100: bytes.  At the MR-STFT loss's shapes (B = 8 x 8 s) the
// STFT's VJP reads 16.4-16.5 MB of spectra and writes 4.1 MB of samples,
// ~6 us at 3.35 TB/s; the ISTFT's VJP at (320, 160) reads 4.1 MB and writes
// 8.25 MB.  An FFT's 5 N log2 N flops a frame are a few microseconds at
// 67 TFLOP/s, so what a kernel can lose is passes through shared memory,
// instructions a frame, and an idle card.  The design:
// - each frame is transformed once, in registers, by the radix FFT of
//   csrc/fft.cuh (N/2-point complex FFT plus the split twiddle step; the
//   inverse as conj(FFT(conj))): two or three passes through shared memory
//   a frame and O(N log N) work, where a two-stage DFT (N = N1 N2) spends
//   O(N (N1 + N2)) FMAs that each wait on a shared-memory load;
// - each input byte is read once, with cp.async into a double buffer: a
//   block stages the next tile's spectra (or dy span) while it transforms
//   the current one (16-byte copies where the quads line up);
// - the STFT's VJP has no halo and no second launch: a persistent
//   cooperative grid walks (row, run) items (as many runs a row as fill the
//   card's resident blocks in one round, where shared memory allows); a
//   run's frames overlap-add into shared memory (frames K apart at once:
//   their samples are disjoint), the positions only its own frames cover go
//   to dx at once (the reflect fold included, since the first and last runs
//   of a row hold K + 1 frames or more), the K - 1 hop-rows it shares with
//   each neighbour go to a small scratch, and after one grid barrier each
//   shared stretch is summed, the earlier run's part first;
// - no float atomics anywhere: the bits do not depend on the grid or on the
//   order blocks run in;
// - blocks of 128 threads, `lanes` a frame; the grid is the card's
//   residency (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) or the
//   work, whichever is smaller.
//
// Any hop: K = ceil(n_fft / hop) is the most frames over a sample, each
// frame spans K hop-rows zero-padded past n_fft (frames K apart still cover
// disjoint samples), an offset q hop + j >= n_fft of a frame covers nothing,
// and a sample in the gap a hop longer than n_fft leaves gets no gradient.
//
// Layout: dre, dim [B, T, n_fft/2+1], dx [B, n], dy [B, L], win [n_fft],
// tab [n_fft] float2, all f32 and contiguous; dre, dim and dy 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // threads a block (ops/cuda/stft.py::VJP_THREADS)

// Switch-offs that time a part of the radix kernels by its absence, for
// utils/kernel_bench.py (built with -DAAS_VJP_SKIP_...; the results are wrong
// then): LOAD stages no input, FFT runs no pass of the transform, OUT does
// nothing with a tile's transform (no overlap-add; no bins split or stored).
#ifdef AAS_VJP_SKIP_LOAD
constexpr bool kLoad = false;
#else
constexpr bool kLoad = true;
#endif
#ifdef AAS_VJP_SKIP_FFT
constexpr bool kFft = false;
#else
constexpr bool kFft = true;
#endif
#ifdef AAS_VJP_SKIP_OUT
constexpr bool kOut = false;
#else
constexpr bool kOut = true;
#endif

__host__ __device__ __forceinline__ int round4(long long n) { return (int)((n + 3) & ~3LL); }

// Shared memory of the radix kernels, in floats, each region a multiple of 4:
// the table, the window, (the ISTFT's VJP) the COLA table, two staging
// buffers and (the ISTFT's VJP) their COLA factors, the exchange array pairs
// a and (the ISTFT's VJP) b, (the STFT's VJP) a run's rows.  The STFT's VJP stages a tile's spectra as two arrays
// (re, im) of `arr` floats, at an offset < 4, and runs the FFT's exchange b
// in the current staging buffer; the ISTFT's VJP stages a tile's dy span.
struct Layout {
  int tw, win, cinv, arr, stage, inv, xa, xb, out;
  long long total() const {
    return (long long)tw + win + cinv + 2LL * stage + 2LL * inv + 2LL * xa + 2LL * xb + out;
  }
};

__host__ __device__ inline Layout layout(bool stft, int n_fft, int hop, int frames, int stride,
                                         int run) {
  const int m = n_fft / 2, k = (n_fft + hop - 1) / hop;
  Layout l;
  l.tw = 2 * n_fft;
  l.win = round4(n_fft);
  l.xa = round4((long long)frames * stride);
  if (stft) {
    const long long spectra = (long long)frames * (m + 1) + 3;
    l.cinv = 0;
    l.arr = round4(spectra > l.xa ? spectra : l.xa);
    l.stage = 2 * l.arr;
    l.inv = 0;
    l.xb = 0;
    l.out = round4((long long)(run + k - 1) * hop);
  } else {
    l.cinv = round4(hop);
    l.arr = 0;
    l.stage = round4((long long)(frames - 1) * hop + n_fft + 3);
    l.inv = round4((long long)(frames - 1) * hop + n_fft);
    l.xb = l.xa;
    l.out = 0;
  }
  return l;
}

// --------------------------------------------------------------- stft_vjp

struct StftVjpParams {
  const float* dre;
  const float* dim;
  const float* win;
  const float2* tab;
  float* dx;
  float* scratch;      // [B * runs][2][(K - 1) hop]: a run's head and tail partial sums
  unsigned* frames_done;  // NULL, or a counter the frames transformed are added to
  int batch, n, frames_t, n_fft, hop, shift, runs;
  fft::Plan plan;
  Layout lay;
};

struct Run {
  int b, r, t0, len;
};

// Item -> (row, run, first frame, frames): T = q runs + rem, and the first
// rem runs of a row take q + 1 frames (32-bit arithmetic only: a 64-bit
// division is a call on the device).
__device__ __forceinline__ Run run_of(const StftVjpParams& p, int item) {
  Run run;
  run.b = item / p.runs;
  run.r = item - run.b * p.runs;
  const int q = p.frames_t / p.runs, rem = p.frames_t - q * p.runs;
  run.t0 = run.r * q + min(run.r, rem);
  run.len = q + (run.r < rem);
  return run;
}

// Stage tile `tile` of run `run` (frames t0 + tile F ...) into buffer s.
__device__ __forceinline__ void stage_spectra(const StftVjpParams& p, const Run& run, int tile,
                                              float* st_re, float* st_im) {
  const int n_bins = p.plan.m + 1, F = p.plan.frames;
  const int a = tile * F;
  const int cnt = min(F, run.len - a);
  const long long lo = ((long long)run.b * p.frames_t + run.t0 + a) * n_bins;
  const long long hi = lo + (long long)cnt * n_bins;
  if (!kLoad) return;
  fft::stage_async(st_re, p.dre, lo & ~3LL, lo, hi);
  fft::stage_async(st_im, p.dim, lo & ~3LL, lo, hi);
}

__global__ void __launch_bounds__(kThreads) stft_vjp_kernel(StftVjpParams p) {
  extern __shared__ float4 smem4[];
  const fft::Plan& plan = p.plan;
  const int m = plan.m, n_fft = p.n_fft, hop = p.hop, F = plan.frames;
  const int n_bins = m + 1, K = (n_fft + hop - 1) / hop;
  // The run rows span whole hop-rows: buf_len is the buffer rounded up to
  // them, and its positions past (T-1) hop + n_fft stay 0.
  const long long buf_len = (long long)(p.frames_t - 1 + K) * hop;
  const int part = (K - 1) * hop;                  // floats of one partial stretch

  float2* tw = reinterpret_cast<float2*>(smem4);
  float* win = reinterpret_cast<float*>(smem4) + p.lay.tw;
  // The staging buffers: re at st0 / st1, im p.lay.arr floats further.
  float* const st0 = win + p.lay.win;
  float* const st1 = st0 + p.lay.stage;
  float* xa_re = st0 + 2 * p.lay.stage;
  float* xa_im = xa_re + p.lay.xa;
  float* out = xa_im + p.lay.xa;                   // [(len + K - 1) hop]: the run's rows

  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) {
    tw[e] = p.tab[e];
    win[e] = p.win[e];
  }
  const int items = p.batch * p.runs;
  int cur = 0;
  if ((int)blockIdx.x < items) stage_spectra(p, run_of(p, blockIdx.x), 0, st0, st0 + p.lay.arr);
  fft::cp_async_commit();

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Run run = run_of(p, item);
    const int rows = (run.len + K - 1) * hop;
    for (int e = threadIdx.x; e < rows; e += blockDim.x) out[e] = 0.f;
    const int tiles = (run.len + F - 1) / F;
    for (int tile = 0; tile < tiles; ++tile) {
      // The block's next tile goes to the other buffer while this one runs.
      float* const next = cur ? st0 : st1;
      if (tile + 1 < tiles)
        stage_spectra(p, run, tile + 1, next, next + p.lay.arr);
      else if (item + (int)gridDim.x < items)
        stage_spectra(p, run_of(p, item + gridDim.x), 0, next, next + p.lay.arr);
      fft::cp_async_commit();
      fft::cp_async_wait<1>();
      __syncthreads();

      const int a = tile * F;
      const int cnt = min(F, run.len - a);
      const int off = (int)((((long long)run.b * p.frames_t + run.t0 + a) * n_bins) & 3);
      float* const b_re = cur ? st1 : st0;         // the staged spectra, then exchange b
      float* const b_im = b_re + p.lay.arr;
      const float* y_re = b_re + off;
      const float* y_im = b_im + off;
      // Pass 0 reads conj(Z_i): Z_i = A_i + i B_i, A_i = (Y_i + conj Y_(M-i)) / 2,
      // B_i = (Y_i - conj Y_(M-i)) / 2 conj(W_N^i); Z_0 = (re_0 + re_M) + i (re_0 - re_M).
      auto first = [&](int f, int i) {
        const float* yr = y_re + f * n_bins;
        const float* yi = y_im + f * n_bins;
        if (i == 0) return make_float2(yr[0] + yr[m], yr[m] - yr[0]);
        const float2 y = make_float2(yr[i], yi[i]);
        const float2 c = make_float2(yr[m - i], -yi[m - i]);
        const float2 A = make_float2(0.5f * (y.x + c.x), 0.5f * (y.y + c.y));
        const float2 D = make_float2(0.5f * (y.x - c.x), 0.5f * (y.y - c.y));
        const float2 w = tw[i];
        const float2 B = make_float2(D.x * w.x + D.y * w.y, D.y * w.x - D.x * w.y);
        return make_float2(A.x - B.y, -(A.y + B.x));
      };
      // The last pass gives conj(z_i); f[2i] = Re z_i, f[2i+1] = Im z_i, windowed,
      // into the exchange array the last pass writes (a or the stage buffer).
      const bool last_in_a = ((plan.passes - 1) & 1) == 0;
      float* xs_re = last_in_a ? xa_re : b_re;
      float* xs_im = last_in_a ? xa_im : b_im;
      auto last = [&](int f, int i, float2 v) {
        const int x = f * plan.stride + fft::slot_index(plan, i);
        xs_re[x] = v.x * win[2 * i];
        xs_im[x] = -v.y * win[2 * i + 1];
      };
      if (kFft) fft::run_fft(plan, tw, cnt, xa_re, xa_im, b_re, b_im, first, last);
      if (kFft && p.frames_done != nullptr && threadIdx.x == 0) atomicAdd(p.frames_done, (unsigned)cnt);

      // Overlap-add: frames f, f + K, f + 2K, ... of a tile cover disjoint
      // samples, so each class c = f mod K adds its frames into the run's
      // rows at once, one exchange point (two samples) a thread, the classes
      // in turn (a fixed order: the bits do not depend on the grid).
      for (int c = 0; kOut && c < K && c < cnt; ++c) {
        for (int f = c; f < cnt; f += K) {
          float* o = out + (a + f) * hop;
          const float* sr = xs_re + f * plan.stride;
          const float* si = xs_im + f * plan.stride;
          for (int i = threadIdx.x; i < m; i += blockDim.x) {
            const int x = fft::slot_index(plan, i);
            o[2 * i] += sr[x];
            o[2 * i + 1] += si[x];
          }
        }
        __syncthreads();
      }
      cur ^= 1;
    }

    // The positions only this run's frames cover, folded onto dx.
    const long long base = (long long)run.t0 * hop;
    const long long plo = run.r == 0 ? 0 : (long long)(run.t0 + K - 1) * hop;
    const long long phi = run.r == p.runs - 1 ? buf_len + p.n : base + (long long)run.len * hop;
    const int ilo = (int)(plo - p.shift > 0 ? plo - p.shift : 0);
    const int ihi = (int)(phi - p.shift < p.n ? phi - p.shift : p.n);
    float* dxb = p.dx + (size_t)run.b * p.n;
    // Samples with no reflected partner (shift < i < n - 1 - shift, where the
    // padded position i + shift < buf_len) take out[] as it is; the rest
    // (both ends of a row) add the padded positions that mirror them.
    const int plain_lo = max(ilo, p.shift + 1);
    const int plain_hi = max(plain_lo, min(ihi, (int)min((long long)p.n - 1 - p.shift,
                                                          buf_len - p.shift)));
    const float* src = out + (p.shift - base);
    for (int i = plain_lo + threadIdx.x; i < plain_hi; i += blockDim.x) dxb[i] = src[i];
    const int heads = max(0, min(ihi, plain_lo) - ilo);
    const int ends = heads + max(0, ihi - max(ilo, plain_hi));
    for (int e = threadIdx.x; e < ends; e += blockDim.x) {
      const int i = e < heads ? ilo + e : max(ilo, plain_hi) + (e - heads);
      long long pos = i + p.shift;
      float v = pos < buf_len ? out[pos - base] : 0.f;
      if (p.shift > 0 && i >= 1 && i <= p.shift) v += out[p.shift - i - base];
      pos = 2LL * (p.n - 1) - i;
      if (p.shift > 0 && pos >= p.n && pos <= p.n - 1 + p.shift && pos + p.shift < buf_len)
        v += out[pos + p.shift - base];
      dxb[i] = v;
    }
    if (part > 0) {
      float* sc = p.scratch + (size_t)item * 2 * part;
      if (run.r > 0)
        for (int e = threadIdx.x; e < part; e += blockDim.x) sc[e] = out[e];
      if (run.r < p.runs - 1)
        for (int e = threadIdx.x; e < part; e += blockDim.x)
          sc[part + e] = out[run.len * hop + e];
    }
    __syncthreads();
  }
  fft::cp_async_wait<0>();

  if (p.runs == 1 || part == 0) return;            // the same for every block
  cg::this_grid().sync();
  // The stretches two runs share: the earlier run's tail, then the later's head.
  const int bounds = p.batch * (p.runs - 1);
  for (int s = blockIdx.x; s < bounds; s += gridDim.x) {
    const int b = s / (p.runs - 1);
    const int item = b * p.runs + (s - b * (p.runs - 1)) + 1;
    const Run run = run_of(p, item);
    const float* tail = p.scratch + (size_t)(item - 1) * 2 * part + part;
    const float* head = p.scratch + (size_t)item * 2 * part;
    float* dxb = p.dx + (size_t)b * p.n + ((long long)run.t0 * hop - p.shift);
    for (int e = threadIdx.x; e < part; e += blockDim.x) dxb[e] = tail[e] + head[e];
  }
}

// -------------------------------------------------------------- istft_vjp

struct IstftVjpParams {
  const float* dy;
  const float* win;
  const float2* tab;
  float* dre;
  float* dim;
  unsigned* frames_done;  // as in StftVjpParams
  int batch, len, frames_t, n_fft, hop, shift;
  fft::Plan plan;
  Layout lay;
};

// Stage tile `tile`'s dy span: buffer position P = t0 hop + x, x < (cnt -
// 1) hop + N, holds dy[P - shift] (zero outside 0 .. L-1), copied to
// dst[x + off] with cp.async, and inv[x] = 1 / max(sum of window^2 over the
// frames that cover P, 1e-8): cinv[P mod hop] where all K frames that can
// cover P exist, the sum over the frames that do at a row's first and last
// K - 1 hop-rows (a frame covers P = (t + q) hop + j where q hop + j < n_fft).
// Returns off (< 4: dst[0] is 16-byte aligned to dy's quads).
__device__ __forceinline__ int stage_dy(const IstftVjpParams& p, int tile, float* dst,
                                        float* inv, const float* cinv, const float* win) {
  const int F = p.plan.frames, hop = p.hop, K = (p.n_fft + hop - 1) / hop;
  const int tiles_b = (p.frames_t + F - 1) / F;
  const int b = tile / tiles_b, t0 = (tile - b * tiles_b) * F;
  const int span = (min(F, p.frames_t - t0) - 1) * hop + p.n_fft;
  const long long row = (long long)b * p.len;
  const long long lo = (long long)t0 * hop - p.shift, hi = lo + span;
  const long long base = (row + lo) & ~3LL;
  long long vlo = lo > 0 ? lo : 0, vhi = hi < p.len ? hi : p.len;
  if (vlo < vhi) {
    if (kLoad) fft::stage_async(dst, p.dy, base, row + vlo, row + vhi);
  } else {
    vhi = vlo = hi;                                // nothing valid: all zero
  }
  for (long long g = lo + threadIdx.x; g < vlo; g += blockDim.x) dst[row + g - base] = 0.f;
  for (long long g = vhi + threadIdx.x; g < hi; g += blockDim.x) dst[row + g - base] = 0.f;
  // Position x = (r - t0) hop + j; (r, j) steps with x by the block's width.
  int r = t0 + threadIdx.x / hop, j = threadIdx.x - (threadIdx.x / hop) * hop;
  for (int x = threadIdx.x; x < span; x += blockDim.x) {
    if (r >= K - 1 && r <= p.frames_t - 1) {
      inv[x] = cinv[j];
    } else {
      float wsq = 0.f;
      for (int q = 0; q < K && q * hop + j < p.n_fft; ++q)
        if (r - q >= 0 && r - q < p.frames_t) wsq += win[q * hop + j] * win[q * hop + j];
      inv[x] = 1.f / fmaxf(wsq, 1e-8f);
    }
    for (j += blockDim.x; j >= hop; j -= hop) ++r;
  }
  return (int)(row + lo - base);
}

__global__ void __launch_bounds__(kThreads) istft_vjp_kernel(IstftVjpParams p) {
  extern __shared__ float4 smem4[];
  const fft::Plan& plan = p.plan;
  const int m = plan.m, n_fft = p.n_fft, hop = p.hop, F = plan.frames;
  const int n_bins = m + 1, K = (n_fft + hop - 1) / hop;
  const int tiles_b = (p.frames_t + F - 1) / F, tiles = p.batch * tiles_b;

  float2* tw = reinterpret_cast<float2*>(smem4);
  float* win = reinterpret_cast<float*>(smem4) + p.lay.tw;
  float* cinv = win + p.lay.win;                   // [hop]: 1 / max(sum_q win[q hop + j]^2, 1e-8)
  float* const st0 = cinv + p.lay.cinv;             // the staging buffers and their
  float* const st1 = st0 + p.lay.stage;             // COLA factors (selected, not indexed)
  float* const inv0 = st1 + p.lay.stage;
  float* const inv1 = inv0 + p.lay.inv;
  float* xa_re = inv1 + p.lay.inv;
  float* xa_im = xa_re + p.lay.xa;
  float* xb_re = xa_im + p.lay.xa;
  float* xb_im = xb_re + p.lay.xa;

  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) {
    tw[e] = p.tab[e];
    win[e] = p.win[e];
  }
  for (int j = threadIdx.x; j < hop; j += blockDim.x) {
    float wsq = 0.f;
    for (int q = 0; q < K && q * hop + j < n_fft; ++q)
      wsq += p.win[q * hop + j] * p.win[q * hop + j];
    cinv[j] = 1.f / fmaxf(wsq, 1e-8f);
  }
  __syncthreads();
  int cur = 0, off0 = 0, off1 = 0;                  // each buffer's offset to dy's quads
  if ((int)blockIdx.x < tiles) off0 = stage_dy(p, blockIdx.x, st0, inv0, cinv, win);
  fft::cp_async_commit();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (tile + (int)gridDim.x < tiles) {
      const int o = stage_dy(p, tile + gridDim.x, cur ? st0 : st1, cur ? inv0 : inv1, cinv, win);
      if (cur) off0 = o;
      else off1 = o;
    }
    fft::cp_async_commit();
    fft::cp_async_wait<1>();
    __syncthreads();

    const int b = tile / tiles_b, t0 = (tile - b * tiles_b) * F;
    const int cnt = min(F, p.frames_t - t0);
    const float* d = (cur ? st1 : st0) + (cur ? off1 : off0);
    const float* inv = cur ? inv1 : inv0;
    // u[n] = win[n] dy[P - shift] / max(sum of window^2, 1e-8) at P = t hop + n.
    auto scaled = [&](int f, int n) {
      const int x = f * hop + n;
      return d[x] * inv[x] * win[n];
    };
    auto first = [&](int f, int i) { return make_float2(scaled(f, 2 * i), scaled(f, 2 * i + 1)); };
    const bool last_in_a = ((plan.passes - 1) & 1) == 0;
    float* z_re = last_in_a ? xa_re : xb_re;
    float* z_im = last_in_a ? xa_im : xb_im;
    auto last = [&](int f, int i, float2 v) {
      const int x = f * plan.stride + fft::slot_index(plan, i);
      z_re[x] = v.x;
      z_im[x] = v.y;
    };
    if (kFft) fft::run_fft(plan, tw, cnt, xa_re, xa_im, xb_re, xb_im, first, last);
    if (kFft && p.frames_done != nullptr && threadIdx.x == 0) atomicAdd(p.frames_done, (unsigned)cnt);

    // The split: X_k = E_k + W_N^k O_k with E_k = (Z_k + conj Z_(M-k)) / 2,
    // O_k = -i (Z_k - conj Z_(M-k)) / 2 (indices mod M), scaled by g_k / N;
    // the tile's bins are contiguous in dre and dim: coalesced stores.  The
    // flat index e = f n_bins + k steps by the block's width; (f, k) follows.
    const size_t o = ((size_t)b * p.frames_t + t0) * n_bins;
    int f = threadIdx.x / n_bins, k = threadIdx.x - f * n_bins;
    for (int e = threadIdx.x; kOut && e < cnt * n_bins; e += blockDim.x) {
      const int ka = k == m ? 0 : k, kb = k == 0 ? 0 : m - k;
      const int xa = f * plan.stride + fft::slot_index(plan, ka);
      const int xb = f * plan.stride + fft::slot_index(plan, kb);
      const float zr = z_re[xa], zi = z_im[xa], cr = z_re[xb], ci = -z_im[xb];
      const float2 E = make_float2(0.5f * (zr + cr), 0.5f * (zi + ci));
      const float2 O = make_float2(0.5f * (zi - ci), -0.5f * (zr - cr));
      const float2 X = fft::cadd(E, fft::cmul(tw[k], O));
      const float g = (k == 0 || k == m ? 1.f : 2.f) / (float)n_fft;
      p.dre[o + e] = X.x * g;
      p.dim[o + e] = X.y * g;
      for (k += blockDim.x; k >= n_bins; k -= n_bins) ++f;
    }
    __syncthreads();
    cur ^= 1;
  }
  fft::cp_async_wait<0>();
}

// ----------------------------------------------------------- direct sums

// The STFT's VJP for a shape the radix plan does not take: one thread a
// sample of dx, each padded position it reads summed over the frames that
// cover it, each frame's value the direct sum over the bins (table in shared
// memory, indexed by (n k) mod N).
__global__ void __launch_bounds__(kThreads)
stft_vjp_direct_kernel(const float* __restrict__ dre, const float* __restrict__ dim,
                       const float* __restrict__ win, const float2* __restrict__ tab,
                       float* __restrict__ dx, int n, int frames_t, int n_fft, int hop,
                       int shift) {
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);
  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) tw[e] = tab[e];
  __syncthreads();
  const int b = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int K = (n_fft + hop - 1) / hop, n_bins = n_fft / 2 + 1;
  const long long buf_len = (long long)(frames_t - 1 + K) * hop;
  auto val = [&](long long pos) {
    float acc = 0.f;
    if (pos >= buf_len) return acc;
    const int r = (int)pos / hop, j = (int)pos - r * hop;
    for (int q = 0; q < K; ++q) {
      const int t = r - q;
      const int nn = q * hop + j;
      if (nn >= n_fft) break;                        // frame t ends before j
      if (t < 0 || t >= frames_t) continue;
      const float* yr = dre + ((size_t)b * frames_t + t) * n_bins;
      const float* yi = dim + ((size_t)b * frames_t + t) * n_bins;
      float s = 0.f;
      int idx = 0;                                   // (nn k) mod N
      for (int k = 0; k < n_bins; ++k) {
        s = fmaf(yr[k], tw[idx].x, s);
        s = fmaf(yi[k], tw[idx].y, s);
        idx += nn;
        if (idx >= n_fft) idx -= n_fft;
      }
      acc += win[nn] * s;
    }
    return acc;
  };
  float v = val(i + shift);
  if (shift > 0) {
    if (i >= 1 && i <= shift) v += val(shift - i);
    const int pos = 2 * (n - 1) - i;
    if (pos >= n && pos <= n - 1 + shift) v += val(pos + shift);
  }
  dx[(size_t)b * n + i] = v;
}

// The ISTFT's VJP for a shape the radix plan does not take: one block a
// frame; its scaled, windowed samples in shared memory, one thread a bin.
__global__ void __launch_bounds__(kThreads)
istft_vjp_direct_kernel(const float* __restrict__ dy, const float* __restrict__ win,
                        const float2* __restrict__ tab, float* __restrict__ dre,
                        float* __restrict__ dim, int len, int frames_t, int n_fft, int hop,
                        int shift) {
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);
  float* u = reinterpret_cast<float*>(tw + n_fft);
  const int t = blockIdx.x, b = blockIdx.y, K = (n_fft + hop - 1) / hop;
  const int n_bins = n_fft / 2 + 1;
  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) {
    tw[e] = tab[e];
    const int src = t * hop + e - shift, r = t + e / hop, j = e % hop;
    float v = 0.f;
    if (src >= 0 && src < len) {
      float wsq = 0.f;
      for (int q = 0; q < K && q * hop + j < n_fft; ++q)
        if (r - q >= 0 && r - q < frames_t) wsq += win[q * hop + j] * win[q * hop + j];
      v = dy[(size_t)b * len + src] * (1.f / fmaxf(wsq, 1e-8f)) * win[e];
    }
    u[e] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float xr = 0.f, xi = 0.f;
    int idx = 0;                                     // (e k) mod N
    for (int e = 0; e < n_fft; ++e) {
      xr = fmaf(u[e], tw[idx].x, xr);
      xi = fmaf(u[e], tw[idx].y, xi);
      idx += k;
      if (idx >= n_fft) idx -= n_fft;
    }
    const float g = (k == 0 || 2 * k == n_fft ? 1.f : 2.f) / (float)n_fft;
    const size_t o = ((size_t)b * frames_t + t) * n_bins + k;
    dre[o] = xr * g;
    dim[o] = xi * g;
  }
}

// ------------------------------------------------------------------ host

// radices: base-32 digits, pass 0 lowest, 0 after the last.  Checks the plan
// against the shape; false for one the kernels do not take.
bool unpack_plan(long long radices, int n_fft, int hop, int lanes, int frames, int pad_shift,
                 int stride, fft::Plan& plan) {
  if (n_fft % 2 || hop % 2 || lanes * frames != kThreads || lanes < 1) return false;
  plan.m = n_fft / 2;
  plan.lanes = lanes;
  plan.frames = frames;
  plan.pad_shift = pad_shift ? pad_shift : 31;     // i >> 31 = 0: no pad
  plan.stride = stride;
  plan.passes = 0;
  long long prod = 1;
  for (; radices && plan.passes < fft::kMaxPasses; radices >>= 5) {
    const int r = (int)(radices & 31);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8 && r != 16) return false;
    plan.radix[plan.passes++] = r;
    prod *= r;
  }
  const int last = plan.m - 1;
  return radices == 0 && plan.passes >= 2 && prod == plan.m && pad_shift >= 0 &&
         pad_shift < 16 && stride >= (pad_shift ? last + (last >> pad_shift) : last) + 1;
}

// The card's residency of a kernel at a dynamic shared-memory size, asked
// once per (device, kernel, size).
struct Residency {
  const void* kernel;
  int device, smem, per_sm, sms;
};

cudaError_t residency(const void* kernel, int smem, int& per_sm, int& sms) {
  static Residency cache[16];
  static int next = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (const Residency& r : cache)
    if (r.kernel == kernel && r.device == device && r.smem == smem) {
      per_sm = r.per_sm;
      sms = r.sms;
      return cudaSuccess;
    }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cache[next] = Residency{kernel, device, smem, per_sm, sms};
  next = (next + 1) % 16;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The STFT's VJP: (dre, dim) [batch, n_frames, n_fft/2+1] -> dx [batch,
// n_samples]; shift = n_fft/2 with the center pad (then n_samples > shift),
// else 0.  The plan (ops/cuda/stft.py::vjp_plan): radices packed as base-32
// digits (0: the direct sums), lanes, frames, run (the most frames of a
// work item: its rows' shared memory), pad_shift, stride; then runs, the
// work items a row splits into (ops/cuda/stft.py::vjp_run_count: n_frames /
// runs rounded up at most run, rounded down K + 1 or more where runs > 1);
// scratch holds batch * runs * 2 * (K - 1) * hop floats; frames_done is
// NULL or a device counter the radix kernel adds the frames it transforms
// to (a check that each is transformed once; the direct sums leave it).  One
// cooperative launch (cudaErrorCooperativeLaunchTooLarge if the card cannot
// hold one block).
extern "C" int aas_stft_vjp(const float* dre, const float* dim, const float* win,
                            const float* tab, float* scratch, long long scratch_len, float* dx,
                            int batch, int n_samples, int n_frames, int n_fft, int hop,
                            int shift, long long radices, int lanes, int frames, int run,
                            int pad_shift, int stride, int runs, unsigned* frames_done,
                            cudaStream_t stream) {
  if (batch == 0 || n_samples == 0) return 0;
  if (n_frames < 1 || hop < 1 || shift < 0 || (shift > 0 && n_samples <= shift))
    return (int)cudaErrorInvalidValue;
  const float2* tab2 = reinterpret_cast<const float2*>(tab);
  const int K = (n_fft + hop - 1) / hop;
  if (radices == 0) {
    const long long smem = (long long)n_fft * sizeof(float2);
    cudaError_t err = allow_smem(stft_vjp_direct_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_samples + kThreads - 1) / kThreads, batch);
    void* args[] = {&dre, &dim, &win, &tab2, &dx, &n_samples, &n_frames, &n_fft, &hop, &shift};
    err = cudaLaunchKernel(stft_vjp_direct_kernel, grid, dim3(kThreads), args, (size_t)smem,
                           stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  StftVjpParams p;
  if (!unpack_plan(radices, n_fft, hop, lanes, frames, pad_shift, stride, p.plan) ||
      run < frames || runs < 1 || (n_frames + runs - 1) / runs > run ||
      (runs > 1 && n_frames / runs < K + 1))
    return (int)cudaErrorInvalidValue;
  p.runs = runs;
  if (scratch_len < (long long)batch * p.runs * 2 * (K - 1) * hop) return (int)cudaErrorInvalidValue;
  p.dre = dre;
  p.dim = dim;
  p.win = win;
  p.tab = tab2;
  p.dx = dx;
  p.scratch = scratch;
  p.frames_done = frames_done;
  p.batch = batch;
  p.n = n_samples;
  p.frames_t = n_frames;
  p.n_fft = n_fft;
  p.hop = hop;
  p.shift = shift;
  p.lay = layout(true, n_fft, hop, frames, stride, run);
  const long long smem = p.lay.total() * (long long)sizeof(float);
  cudaError_t err = allow_smem(stft_vjp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = residency(reinterpret_cast<const void*>(stft_vjp_kernel), (int)smem, per_sm, sms);
  if (err != cudaSuccess) return (int)err;
  const int items = batch * p.runs;
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(stft_vjp_kernel, dim3(grid), dim3(kThreads), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The ISTFT's VJP: dy [batch, out_len] (the gradient of aas_istft's trimmed
// output, shift = its center trim) -> (dre, dim) [batch, n_frames,
// n_fft/2+1]; the plan and frames_done as in aas_stft_vjp (run unused).  One
// launch of a persistent grid.
extern "C" int aas_istft_vjp(const float* dy, const float* win, const float* tab, float* dre,
                             float* dim, int batch, int out_len, int n_frames, int n_fft,
                             int hop, int shift, long long radices, int lanes, int frames,
                             int pad_shift, int stride, unsigned* frames_done,
                             cudaStream_t stream) {
  if (batch == 0 || n_frames == 0) return 0;
  if (hop < 1 || shift < 0 || out_len < 0) return (int)cudaErrorInvalidValue;
  const float2* tab2 = reinterpret_cast<const float2*>(tab);
  if (radices == 0) {
    const long long smem = (long long)n_fft * (sizeof(float2) + sizeof(float));
    cudaError_t err = allow_smem(istft_vjp_direct_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&dy, &win, &tab2, &dre, &dim, &out_len, &n_frames, &n_fft, &hop, &shift};
    err = cudaLaunchKernel(istft_vjp_direct_kernel, dim3(n_frames, batch), dim3(kThreads), args,
                           (size_t)smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  IstftVjpParams p;
  if (!unpack_plan(radices, n_fft, hop, lanes, frames, pad_shift, stride, p.plan))
    return (int)cudaErrorInvalidValue;
  p.dy = dy;
  p.win = win;
  p.tab = tab2;
  p.dre = dre;
  p.dim = dim;
  p.frames_done = frames_done;
  p.batch = batch;
  p.len = out_len;
  p.frames_t = n_frames;
  p.n_fft = n_fft;
  p.hop = hop;
  p.shift = shift;
  p.lay = layout(false, n_fft, hop, frames, stride, 0);
  const long long smem = p.lay.total() * (long long)sizeof(float);
  cudaError_t err = allow_smem(istft_vjp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = residency(reinterpret_cast<const void*>(istft_vjp_kernel), (int)smem, per_sm, sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = batch * ((n_frames + frames - 1) / frames);
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchKernel(istft_vjp_kernel, dim3(grid), dim3(kThreads), args, (size_t)smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What one launch of a VJP kernel holds (for the checks that print it):
// out[0] blocks resident on an SM, [1] dynamic shared memory a block in
// bytes, [2] registers a thread, [3] local memory a thread in bytes (spills),
// [4] threads a block.  which: 0 the STFT's VJP, 1 the ISTFT's; the plan as
// in aas_stft_vjp (radices 0: the direct kernel).
extern "C" int aas_vjp_residency(int which, int n_fft, int hop, long long radices, int lanes,
                                 int frames, int run, int pad_shift, int stride, int* out) {
  const void* kernel;
  long long smem;
  if (radices == 0) {
    kernel = which == 0 ? reinterpret_cast<const void*>(stft_vjp_direct_kernel)
                        : reinterpret_cast<const void*>(istft_vjp_direct_kernel);
    smem = (long long)n_fft * (which == 0 ? sizeof(float2) : sizeof(float2) + sizeof(float));
  } else {
    fft::Plan plan;
    if (!unpack_plan(radices, n_fft, hop, lanes, frames, pad_shift, stride, plan))
      return (int)cudaErrorInvalidValue;
    kernel = which == 0 ? reinterpret_cast<const void*>(stft_vjp_kernel)
                        : reinterpret_cast<const void*>(istft_vjp_kernel);
    smem = layout(which == 0, n_fft, hop, frames, stride, run).total() * (long long)sizeof(float);
  }
  cudaError_t err = which == 0 ? (radices ? allow_smem(stft_vjp_kernel, smem)
                                          : allow_smem(stft_vjp_direct_kernel, smem))
                               : (radices ? allow_smem(istft_vjp_kernel, smem)
                                          : allow_smem(istft_vjp_direct_kernel, smem));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
