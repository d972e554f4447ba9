// Inverse real DFT of every frame, windowed overlap-add, COLA normalization,
// center trim and length: the ISTFT, in gather form.
//
// Replaces: aas_enhancement_tpu/ops/pallas/stft_kernel.py::istft_pallas
// (body _istft_kernel plus the seam add, COLA divide and trim its wrapper
// does).  The Pallas kernel computes head/tail halves of each frame as matrix
// products against the n_fft x (n_fft/2+1) inverse basis and overlap-adds
// them with a row roll and a seam row carried across tiles.  Here a block
// inverse-transforms kF frames into shared memory and gathers every output
// sample: sample j of hop-row r sums the K = n_fft/hop frames t = r - q that
// cover it, at frame offset n = q*hop + j, and is divided by max(sum of
// window^2, 1e-8).  The block's first K-1 frames are the halo it shares with
// the block before (each block transforms them again), so a block writes
// kF - K + 1 hop-rows; no atomics, and each output sample is written once,
// straight into the trimmed [B, out_len] output (zero past the last frame).
//
// The transform (istft_fact_kernel) is the adjoint of the STFT's two stages
// (csrc/stft.cu) for n_fft = N1 N2, with n = N2 n1 + n2 and k = k1 + N1 k2:
//   B[k1][n2]  = sum_k2 Y[k1 + N1 k2] W_N2^-(n2 k2)     N2-point complex inverse DFTs
//   B'[k1][n2] = B[k1][n2] W_N^-(n2 k1)                 the conjugate twiddles
//   x[N2 n1 + n2] = Re sum_k1 W_N1^-(n1 k1) B'[k1][n2]  N1-point DFTs to real samples
// where Y is the spectrum extended by Y[N - k] = conj(Y[k]) and scaled by
// 1/N at staging.  A real output makes row N1 - k1 of B' the conjugate of row
// k1, so stage A runs only the rows k1 = 0 .. N1/2 and stage B counts the
// rows 0 < k1 < N1/2 twice (a weight folded into B' as it is stored); the
// imaginary parts of the DC and Nyquist bins drop out of Re, as in the
// weighted real basis of the plain version.  At n_fft = 320 = 32 x 10 that
// is 17,680 FMAs a frame where the direct sum spends 103,040.
//
// Bound on the H100: bytes.  The function reads the spectra and writes the
// samples once: 4.2 MB at B = 4 x 8 s, 1.3 us at 3.35 TB/s; an FFT's
// operations are fewer still.  What the kernel waits on is shared-memory
// loads and the launch, so the design keeps loads per FMA low, as the STFT
// kernel does: a thread owns one (k1, n2) pair (stage A) or one (n1, n2)
// pair (stage B) for all kF frames, so one table read feeds 2-4 kF FMAs; the
// staged spectra and B' hold the frame index fastest and are read as 16-byte
// loads that the threads of a warp share (stage B puts n1 fastest across the
// warp, so all of a warp reads one n2 column of B': a broadcast).  The bases
// come from the STFT's f32 table of W_N^m = (cos, -sin)(2 pi m / N), m < N,
// built on the host in double precision (W_N1^m = W_N^(m N2), W_N2^m =
// W_N^(m N1)); the inverse takes their conjugates.
//
// An n_fft with no factorisation that saves operations (a prime), or more
// than 8 frames over a sample, takes the direct sum (istft_direct_kernel):
// every sample the inverse rDFT over the n_fft/2+1 bins from a shared-memory
// table, kRows hop-rows a block.  The caller picks the route by the shape
// (ops/cuda/stft.py::istft_route): n1 = 0 means direct.
//
// The same device code, instantiated with Out::kStftGrad, is the STFT's
// vector-Jacobian product (aas_stft_vjp; no TPU counterpart: the JAX package
// differentiates its matmul-DFT STFT with XLA).  The STFT is linear, so its
// adjoint maps (dre, dim) [B, T, n_fft/2+1] to dx [B, n]: each frame's
// gradient is dre_k cos - dim_k sin summed over the bins k <= n_fft/2 with
// weight 1 on every bin (the adjoint of the real DFT, not the inverse: no
// 1/n_fft, and the interior bins are not doubled), so the spectra are staged
// scaled by 1/g_k (the transform below doubles the interior bins for their
// mirrors); then the window, and the overlap-add with no division, into the
// buffer of the reflect-padded signal [(T-1+K) hop].  A second launch
// (stft_vjp_fold_kernel) folds that buffer onto the real samples: sample i
// gathers buffer sample i + shift and, within n_fft/2 of an edge, the padded
// position that mirrors it; the zero tail past the padded signal is dropped.
//
// Layout: re/im [B, T, n_fft/2+1], win [n_fft], tab [n_fft] float2,
// y [B, out_len], all f32 and contiguous.  Output sample o is sample o + shift
// of the overlap-add buffer [(T-1+K)*hop] (shift = n_fft/2 with center, else
// 0); o past the buffer is 0.  Requires hop | n_fft.

#include <cuda_runtime.h>

#include "dft_table.cuh"

namespace {

constexpr int kRows = 8;   // hop-rows of output per block of the direct kernel

// What the overlap-add writes: the ISTFT's trimmed, COLA-normalised output,
// or the STFT's VJP's untrimmed, unnormalised buffer (shift 0, out_len the
// buffer's length).
enum class Out { kTrimmed, kStftGrad };

// The staged scale of bin k: 1/n_fft for the inverse, 1/g_k for the STFT's
// adjoint (g = 1 at DC and Nyquist, 2 between, as the transform weighs them).
template <Out kOut>
__device__ __forceinline__ float stage_scale(int k, int n_fft) {
  if constexpr (kOut == Out::kTrimmed) return 1.f / (float)n_fft;
  return (k == 0 || 2 * k == n_fft) ? 1.f : 0.5f;
}

template <int kF, Out kOut>
__global__ void istft_fact_kernel(const float* __restrict__ re,
                                  const float* __restrict__ im,
                                  const float* __restrict__ win,
                                  const float2* __restrict__ tab,
                                  float* __restrict__ y, int n_frames, int n_fft,
                                  int hop, int N1, int N2, int shift, int out_len,
                                  int r_lo) {
  static_assert(kF % 4 == 0, "frames are read as float4");
  extern __shared__ float4 smem4[];
  const int K = n_fft / hop;             // frames covering one sample
  const int R = kF - K + 1;              // hop-rows this block writes
  const int K1 = N1 / 2 + 1;
  const int items = K1 * N2;
  const int n_bins = n_fft / 2 + 1;
  float* sre = reinterpret_cast<float*>(smem4);    // [n_bins][kF]: Re X / N
  float* sim = sre + n_bins * kF;                  // [n_bins][kF]: Im X / N
  float* br = sim + n_bins * kF;                   // [K1 * N2][kF]: weighted Re B'
  float* bi = br + items * kF;                     // [K1 * N2][kF]: weighted Im B'
  float2* tab1 = reinterpret_cast<float2*>(bi + items * kF);   // [N1]: W_N1^m
  float2* tab2 = tab1 + N1;                        // [N2]: W_N2^m
  float* xs = reinterpret_cast<float*>(tab2 + N2);  // [kF][n_fft]: windowed frames
  float* ws = xs + kF * n_fft;                     // [n_fft]: the window

  const int b = blockIdx.y;
  const int r0 = r_lo + blockIdx.x * R;
  const int t0 = r0 - (K - 1);                     // frame in staged slot 0

  for (int e = threadIdx.x; e < N1; e += blockDim.x) tab1[e] = tab[e * N2];
  for (int e = threadIdx.x; e < N2; e += blockDim.x) tab2[e] = tab[e * N1];
  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) ws[e] = win[e];
  for (int e = threadIdx.x; e < kF * n_bins; e += blockDim.x) {
    const int f = e / n_bins;
    const int k = e - f * n_bins;
    const int t = t0 + f;
    const bool valid = t >= 0 && t < n_frames;
    const size_t src = ((size_t)b * n_frames + (valid ? t : 0)) * n_bins + k;
    const float scale = stage_scale<kOut>(k, n_fft);
    sre[k * kF + f] = valid ? re[src] * scale : 0.f;
    sim[k * kF + f] = valid ? im[src] * scale : 0.f;
  }
  __syncthreads();

  // Stage A and the twiddles: one thread per (k1, n2), n2 fastest.
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k1 = item / N2;
    const int n2 = item - k1 * N2;
    float ar[kF], ai[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      ar[f] = 0.f;
      ai[f] = 0.f;
    }
    int idx = 0;                                   // (n2 k2) mod N2
    for (int k2 = 0; k2 < N2; ++k2) {
      // Y[k] = X[k] for k <= N/2, conj(X[N - k]) above.
      const int k = k1 + N1 * k2;
      const bool mirrored = 2 * k > n_fft;
      const int src = mirrored ? n_fft - k : k;
      const float sg = mirrored ? -1.f : 1.f;
      // (yr + i sg yi) * conj(w): re += yr w.x + yi (sg w.y), im += yi (sg w.x) - yr w.y
      const float2 w = tab2[idx];
      const float cy = sg * w.y, cx = sg * w.x;
      const float4* yr4 = reinterpret_cast<const float4*>(sre + src * kF);
      const float4* yi4 = reinterpret_cast<const float4*>(sim + src * kF);
#pragma unroll
      for (int v = 0; v < kF / 4; ++v) {
        const float4 r4 = yr4[v], i4 = yi4[v];
        const float yr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float yi[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int f = 4 * v + u;
          ar[f] = fmaf(yr[u], w.x, ar[f]);
          ar[f] = fmaf(yi[u], cy, ar[f]);
          ai[f] = fmaf(yi[u], cx, ai[f]);
          ai[f] = fmaf(-yr[u], w.y, ai[f]);
        }
      }
      idx += n2;                                   // n2 < N2, so one wrap suffices
      if (idx >= N2) idx -= N2;
    }
    // B' = B conj(W_N^(n2 k1)), weighted 2 for the rows that stand for their mirror.
    const float2 tw = tab[n2 * k1];                // n2 k1 < N
    const float g = (k1 == 0 || 2 * k1 == N1) ? 1.f : 2.f;
    const float twx = g * tw.x, twy = g * tw.y;
    float4* o_r = reinterpret_cast<float4*>(br + item * kF);
    float4* o_i = reinterpret_cast<float4*>(bi + item * kF);
#pragma unroll
    for (int v = 0; v < kF / 4; ++v) {
      float vr[4], vi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * v + u;
        vr[u] = ar[f] * twx + ai[f] * twy;
        vi[u] = ai[f] * twx - ar[f] * twy;
      }
      o_r[v] = make_float4(vr[0], vr[1], vr[2], vr[3]);
      o_i[v] = make_float4(vi[0], vi[1], vi[2], vi[3]);
    }
  }
  __syncthreads();

  // Stage B: one thread per (n1, n2), n1 fastest; Re(conj(w) B') = w.x br + w.y bi.
  for (int item = threadIdx.x; item < n_fft; item += blockDim.x) {
    const int n2 = item / N1;
    const int n1 = item - n2 * N1;
    float acc[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) acc[f] = 0.f;
    int idx = 0;                                   // (n1 k1) mod N1
    for (int k1 = 0; k1 < K1; ++k1) {
      const float2 w = tab1[idx];
      const float4* r4 = reinterpret_cast<const float4*>(br + (k1 * N2 + n2) * kF);
      const float4* i4 = reinterpret_cast<const float4*>(bi + (k1 * N2 + n2) * kF);
#pragma unroll
      for (int v = 0; v < kF / 4; ++v) {
        const float4 a = r4[v], c = i4[v];
        const float vr[4] = {a.x, a.y, a.z, a.w};
        const float vi[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[4 * v + u] = fmaf(vr[u], w.x, acc[4 * v + u]);
          acc[4 * v + u] = fmaf(vi[u], w.y, acc[4 * v + u]);
        }
      }
      idx += n1;                                   // n1 < N1, so one wrap suffices
      if (idx >= N1) idx -= N1;
    }
    const int n = N2 * n1 + n2;
    const float wn = ws[n];
#pragma unroll
    for (int f = 0; f < kF; ++f) xs[f * n_fft + n] = acc[f] * wn;
  }
  __syncthreads();

  // Overlap-add in gather form, COLA divide, trimmed store.
  for (int e = threadIdx.x; e < R * hop; e += blockDim.x) {
    const int rr = e / hop;
    const int j = e - rr * hop;
    const int r = r0 + rr;
    const int o = r * hop + j - shift;
    if (o < 0 || o >= out_len) continue;
    float acc = 0.f, wsq = 0.f;
    for (int q = 0; q < K; ++q) {                  // frame t = r - q, staged at rr + K-1-q
      const int n = q * hop + j;
      acc += xs[(rr + K - 1 - q) * n_fft + n];
      const int t = r - q;
      if (kOut == Out::kTrimmed && t >= 0 && t < n_frames) wsq = fmaf(ws[n], ws[n], wsq);
    }
    y[(size_t)b * out_len + o] = kOut == Out::kTrimmed ? acc / fmaxf(wsq, 1e-8f) : acc;
  }
}

template <Out kOut>
__global__ void istft_direct_kernel(const float* __restrict__ re,
                                    const float* __restrict__ im,
                                    const float* __restrict__ win,
                                    float* __restrict__ y, int n_frames, int n_fft,
                                    int hop, int shift, int out_len, int r_lo) {
  extern __shared__ float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int K = n_fft / hop;             // frames covering one sample
  const int nf = kRows + K - 1;          // frames this tile reads
  float* cos_tab = smem;                 // [n_fft]
  float* nsin_tab = cos_tab + n_fft;     // [n_fft]
  float* sre = nsin_tab + n_fft;         // [nf][n_bins], scaled by g_k/n_fft
  float* sim = sre + nf * n_bins;        // [nf][n_bins]

  const int b = blockIdx.y;
  const int r0 = r_lo + blockIdx.x * kRows;
  const int tf0 = r0 - (K - 1);          // frame held in staged slot 0

  fill_dft_table(cos_tab, nsin_tab, n_fft);
  for (int e = threadIdx.x; e < nf * n_bins; e += blockDim.x) {
    const int fi = e / n_bins;
    const int k = e - fi * n_bins;
    const int t = tf0 + fi;
    // Inverse rfft weights: 1 for DC and Nyquist, 2 for the others, / n_fft;
    // for the STFT's adjoint 1 on every bin.
    const float g = kOut == Out::kTrimmed
                        ? ((k == 0 || 2 * k == n_fft) ? 1.f : 2.f) / (float)n_fft
                        : 1.f;
    const bool valid = t >= 0 && t < n_frames;
    const size_t src = ((size_t)b * n_frames + (valid ? t : 0)) * n_bins + k;
    sre[e] = valid ? re[src] * g : 0.f;
    sim[e] = valid ? im[src] * g : 0.f;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < hop; j += blockDim.x) {
    float out[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) out[rr] = 0.f;

    for (int q = 0; q < K; ++q) {        // frame t = r - q, offset n inside it
      const int n = q * hop + j;
      float part[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) part[rr] = 0.f;
      int idx = 0;                       // (k * n) mod n_fft
      for (int k = 0; k < n_bins; ++k) {
        const float c = cos_tab[idx];
        const float s = nsin_tab[idx];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int slot = (rr + K - 1 - q) * n_bins + k;
          part[rr] = fmaf(sre[slot], c, part[rr]);
          part[rr] = fmaf(sim[slot], s, part[rr]);
        }
        idx += n;                        // n < n_fft, so one wrap suffices
        if (idx >= n_fft) idx -= n_fft;
      }
      const float wn = win[n];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) out[rr] = fmaf(wn, part[rr], out[rr]);
    }

#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = r0 + rr;
      const int o = r * hop + j - shift;
      if (o < 0 || o >= out_len) continue;
      if constexpr (kOut == Out::kStftGrad) {
        y[(size_t)b * out_len + o] = out[rr];
        continue;
      }
      float wsq = 0.f;                   // COLA: window^2 summed over frames
      for (int q = 0; q < K; ++q) {
        const int t = r - q;
        if (t >= 0 && t < n_frames) {
          const float w = win[q * hop + j];
          wsq += w * w;
        }
      }
      y[(size_t)b * out_len + o] = out[rr] / fmaxf(wsq, 1e-8f);
    }
  }
}

// dx[i] = buf[i + shift], plus, where the center pad mirrored sample i, the
// buffer sample of that padded position: pos = -i (1 <= i <= shift) and pos =
// 2 (n - 1) - i (n <= pos <= n - 1 + shift).  Buffer samples past its end
// are zero (no frame covered them).
__global__ void stft_vjp_fold_kernel(const float* __restrict__ buf, float* __restrict__ dx,
                                     int n, int buf_len, int shift) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* bb = buf + (size_t)b * buf_len;
  float v = i + shift < buf_len ? bb[i + shift] : 0.f;
  if (i >= 1 && i <= shift && shift - i < buf_len) v += bb[shift - i];
  const int pos = 2 * (n - 1) - i;
  if (shift > 0 && pos >= n && pos <= n - 1 + shift && pos + shift < buf_len)
    v += bb[pos + shift];
  dx[(size_t)b * n + i] = v;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int block_threads(int n) {
  const int threads = ((n + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

template <int kF, Out kOut>
int launch_fact(const float* re, const float* im, const float* win, const float2* tab,
                float* y, int batch, int n_frames, int n_fft, int hop, int n1, int n2,
                int shift, int out_len, int r_lo, int r_hi, cudaStream_t stream) {
  const int R = kF - n_fft / hop + 1;
  const int items = (n1 / 2 + 1) * n2;
  const size_t smem = ((size_t)2 * kF * (n_fft / 2 + 1) + (size_t)2 * kF * items +
                       2 * (n1 + n2) + (size_t)(kF + 1) * n_fft) * sizeof(float);
  cudaError_t err = allow_smem(istft_fact_kernel<kF, kOut>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((r_hi - r_lo + R - 1) / R, batch);
  const int threads = block_threads(items > n_fft ? items : n_fft);
  istft_fact_kernel<kF, kOut><<<grid, threads, smem, stream>>>(
      re, im, win, tab, y, n_frames, n_fft, hop, n1, n2, shift, out_len, r_lo);
  return (int)cudaGetLastError();
}

// The inverse transform and overlap-add, writing y [batch, out_len]: sample o
// is sample o + shift of the overlap-add buffer (kOut::kTrimmed), or the
// buffer itself (kStftGrad: shift 0, out_len the buffer's length).
template <Out kOut>
int launch(const float* re, const float* im, const float* win, const float* tab,
           float* y, int batch, int n_frames, int n_fft, int hop, int shift, int out_len,
           int n1, int n2, cudaStream_t stream) {
  if (batch == 0 || out_len == 0) return 0;
  if (n_frames < 1 || hop < 1 || n_fft % hop || shift < 0)
    return (int)cudaErrorInvalidValue;
  const int K = n_fft / hop;
  const int r_lo = shift / hop;                          // the row of sample 0
  const int r_hi = (shift + out_len + hop - 1) / hop;    // one past the last sample's
  if (n1 == 0) {
    const int n_bins = n_fft / 2 + 1;
    const size_t smem =
        (size_t)(2 * n_fft + 2 * (kRows + K - 1) * n_bins) * sizeof(float);
    cudaError_t err = allow_smem(istft_direct_kernel<kOut>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((r_hi - r_lo + kRows - 1) / kRows, batch);
    istft_direct_kernel<kOut><<<grid, block_threads(hop), smem, stream>>>(
        re, im, win, y, n_frames, n_fft, hop, shift, out_len, r_lo);
    return (int)cudaGetLastError();
  }
  if (n1 < 2 || n2 < 2 || n1 * n2 != n_fft || K > 8) return (int)cudaErrorInvalidValue;
  const float2* tab2 = reinterpret_cast<const float2*>(tab);
  if (K <= 4)
    return launch_fact<8, kOut>(re, im, win, tab2, y, batch, n_frames, n_fft, hop, n1, n2,
                                shift, out_len, r_lo, r_hi, stream);
  return launch_fact<16, kOut>(re, im, win, tab2, y, batch, n_frames, n_fft, hop, n1, n2,
                               shift, out_len, r_lo, r_hi, stream);
}

}  // namespace

// n1 * n2 = n_fft picks the factorised kernel (at most 8 frames over a
// sample: kF = 8 frames a block up to 4 of them, 16 up to 8), n1 = 0 the
// direct sum.  y is the trimmed output [batch, out_len]: sample o is sample
// o + shift of the overlap-add buffer.
extern "C" int aas_istft(const float* re, const float* im, const float* win,
                         const float* tab, float* y, int batch, int n_frames,
                         int n_fft, int hop, int shift, int out_len, int n1, int n2,
                         cudaStream_t stream) {
  return launch<Out::kTrimmed>(re, im, win, tab, y, batch, n_frames, n_fft, hop, shift,
                               out_len, n1, n2, stream);
}

// The STFT's VJP: (dre, dim) [batch, n_frames, n_fft/2+1] -> dx [batch,
// n_samples], through buf [batch, (n_frames - 1 + n_fft/hop) hop] (the
// padded signal's gradient, written by the first launch and folded by the
// second).  shift = n_fft/2 with the center pad (then n_samples > shift),
// else 0; n1, n2 as in aas_istft.
extern "C" int aas_stft_vjp(const float* dre, const float* dim, const float* win,
                            const float* tab, float* buf, float* dx, int batch,
                            int n_samples, int n_frames, int n_fft, int hop, int shift,
                            int n1, int n2, cudaStream_t stream) {
  if (batch == 0 || n_samples == 0) return 0;
  if (hop < 1 || n_fft % hop || shift < 0 || (shift > 0 && n_samples <= shift))
    return (int)cudaErrorInvalidValue;
  const int buf_len = (n_frames - 1 + n_fft / hop) * hop;
  int err = launch<Out::kStftGrad>(dre, dim, win, tab, buf, batch, n_frames, n_fft, hop,
                                   0, buf_len, n1, n2, stream);
  if (err != 0) return err;
  const dim3 grid((n_samples + 255) / 256, batch);
  stft_vjp_fold_kernel<<<grid, 256, 0, stream>>>(buf, dx, n_samples, buf_len, shift);
  return (int)cudaGetLastError();
}
