// Windowed real DFT of every frame: the STFT's forward transform.
//
// Replaces: aas_enhancement_tpu/ops/pallas/stft_kernel.py::stft_pallas
// (body _stft_kernel).  The Pallas kernel multiplies hop-wide head/tail rows
// by cos/-sin basis matrices on the MXU, the whole n_fft x (n_fft/2+1) direct
// sum.  Here a block stages kFrames windowed frames in shared memory and
// computes each frame's transform in two stages (Cooley-Tukey) for
// n_fft = N1 N2, with the sample index n = N2 n1 + n2 and the bin index
// k = k1 + N1 k2:
//   A[k1][n2]  = sum_n1 x[N2 n1 + n2] W_N1^(n1 k1)      N1-point DFTs of real data
//   A'[k1][n2] = A[k1][n2] W_N^(n2 k1)                  the twiddles between the stages
//   X[k1 + N1 k2] = sum_n2 A'[k1][n2] W_N2^(n2 k2)      N2-point complex DFTs
// The input is real, so X[N - k] = conj(X[k]): stage 1 keeps only k1 = 0 ..
// N1/2, and a stage-2 result whose k lies above n_fft/2 is stored conjugated
// at bin N - k (the rows k1 = 0 and 2 k1 = N1 give every one of their bins
// directly, so their upper halves are dropped).  Each of the n_fft/2+1 bins is
// written exactly once.  At n_fft = 320 = 32 x 10 that is 17,680 FMAs a frame
// where the direct sum spends 103,040.
//
// Bound on the H100: the function moves 6.2 MB at B = 4 x 8 s (each sample
// read once, each bin written once: 1.8 us at 3.35 TB/s) and an FFT's
// operations are fewer still, so bytes bound it; what the kernel itself waits
// on is shared-memory loads and the launch: 16 us on the device there (NVIDIA
// H100 80GB HBM3, 700.00 W), and a single call costs the host more than that
// (0.04-0.07 ms between two events, as torch.stft).  The design keeps loads per FMA
// low: a thread owns one (k1, n2) or (k1, k2) pair for all kFrames frames, so
// one table read feeds 2-4 kFrames FMAs; stage 2 reads A' of its kFrames
// frames as 16-byte broadcast loads (the frame index is the fastest in
// shared memory); stage 1 reads x with unit stride across a warp; the bins
// are staged transposed so that stage 2's stores do not collide on one bank,
// and leave through shared memory so that the stores to re and im, kFrames x
// (n_fft/2+1) contiguous floats each, are coalesced.  The bases come from one
// f32 table of W_N^m = (cos, -sin)(2 pi m / N), m < N, built on the host in
// double precision once per (n_fft, device) and passed in: W_N1^m =
// W_N^(m N2), W_N2^m = W_N^(m N1).  The center reflect pad is index
// arithmetic on the loads (mirrored at both edges), so the caller launches no
// copy.
//
// An n_fft with no factorisation that saves operations (a prime) takes the
// direct sum (stft_direct_kernel): one thread per bin, kFrames accumulators,
// bases from the same table indexed by (n k) mod n_fft.  The caller picks
// (ops/cuda/stft.py::stft_factors): n1 = 0 means direct.
//
// The same device code, instantiated with Src::kIstftGrad, is the ISTFT's
// vector-Jacobian product (aas_istft_vjp; no TPU counterpart: the JAX package
// differentiates its matmul-DFT ISTFT with XLA).  The ISTFT is linear, y =
// trim(OLA(win * irDFT_g(X)) / max(sum win^2, 1e-8)), so its adjoint maps dy
// [B, L] to (dre, dim): undo the trim (dy at buffer sample o + shift, zero at
// the head and past L), divide by max(sum win^2, 1e-8) (the frames' window
// squares, summed as the ISTFT kernel sums them), frame with the window and
// forward-transform; the store scales bin k by g_k / n_fft, g = 1 at DC and
// Nyquist and 2 between (the inverse's weights).  Frames read the buffer with
// zero padding: no reflection.
//
// Layout: x [B, n_samples] (dy [B, L] for the VJP), win [n_fft], tab [n_fft]
// float2, re/im [B, T, n_fft/2+1], all f32 and contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 8;   // frames per block

// What a block stages as its frames: the signal (the STFT) or the ISTFT's
// output gradient (its VJP).
enum class Src { kSignal, kIstftGrad };

// xs[f][n] = win[n] * x[t0 + f][n].  kSignal: the frame's samples taken from
// x with the center pad's mirrored indices (shift = n_fft/2 with center, else
// 0); frames past the last, and samples past the padded signal, are zero.
// kIstftGrad: x is dy [B, n_samples = L], the trimmed output's gradient;
// buffer sample p = t hop + n is dy[p - shift] (zero outside 0 .. L-1)
// divided by max(sum win^2, 1e-8) over the frames 0 .. n_frames-1 that
// cover p.
template <Src kSrc>
__device__ __forceinline__ void load_frames(const float* __restrict__ xb,
                                            const float* __restrict__ win,
                                            float* __restrict__ xs, int t0,
                                            int n_samples, int n_frames, int n_fft,
                                            int hop, int shift) {
  for (int e = threadIdx.x; e < kFrames * n_fft; e += blockDim.x) {
    const int f = e / n_fft;
    const int n = e - f * n_fft;
    const int t = t0 + f;
    float v = 0.f;
    int pos = t * hop + n - shift;
    if constexpr (kSrc == Src::kSignal) {
      if (t < n_frames && pos < n_samples + shift) {   // an odd n_fft's last frame
        if (pos < 0) pos = -pos;                       // ends one past the padded
        if (pos >= n_samples) pos = 2 * (n_samples - 1) - pos;   // signal: zero
        v = xb[pos] * win[n];
      }
    } else {
      if (t < n_frames && pos >= 0 && pos < n_samples) {
        const int j = n % hop;                         // p = (t + n / hop) hop + j
        const int r = t + n / hop;
        float wsq = 0.f;
        for (int q = 0; q * hop < n_fft; ++q) {        // frame r - q covers p at q hop + j
          const int tt = r - q;
          if (tt >= 0 && tt < n_frames) wsq = fmaf(win[q * hop + j], win[q * hop + j], wsq);
        }
        v = xb[pos] / fmaxf(wsq, 1e-8f) * win[n];
      }
    }
    xs[e] = v;
  }
}

// The scale of bin k on the store: 1 for the STFT, g_k / n_fft for the ISTFT's VJP.
template <Src kSrc>
__device__ __forceinline__ float bin_scale(int k, int n_fft) {
  if constexpr (kSrc == Src::kSignal) return 1.f;
  return ((k == 0 || 2 * k == n_fft) ? 1.f : 2.f) / (float)n_fft;
}

template <Src kSrc>
__global__ void stft_fact_kernel(const float* __restrict__ x,
                                 const float* __restrict__ win,
                                 const float2* __restrict__ tab,
                                 float* __restrict__ re, float* __restrict__ im,
                                 int n_samples, int n_frames, int n_fft, int hop,
                                 int shift, int N1, int N2) {
  static_assert(kFrames == 8, "stage 2 reads a pair's frames as two float4");
  extern __shared__ float4 smem4[];
  const int K1 = N1 / 2 + 1;
  const int items = K1 * N2;
  const int n_bins = n_fft / 2 + 1;
  float* ar = reinterpret_cast<float*>(smem4);     // [K1 * N2][kFrames]: Re A'
  float* ai = ar + items * kFrames;                // [K1 * N2][kFrames]: Im A'
  float2* tab1 = reinterpret_cast<float2*>(ai + items * kFrames);   // [N1]: W_N1^m
  float2* tab2 = tab1 + N1;                        // [N2]: W_N2^m
  float* xs = reinterpret_cast<float*>(tab2 + N2);  // [kFrames][n_fft], windowed
  // Bin k = k1 + N1 k2 is staged at [k1][k2], k2 <= N2/2: a warp's stage-2
  // stores, whose k are N1 apart, fall on neighbouring words.
  const int S = N2 / 2 + 1;
  float* ore = xs + kFrames * n_fft;               // [kFrames][N1][S]
  float* oim = ore + kFrames * N1 * S;             // [kFrames][N1][S]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;

  for (int e = threadIdx.x; e < N1; e += blockDim.x) tab1[e] = tab[e * N2];
  for (int e = threadIdx.x; e < N2; e += blockDim.x) tab2[e] = tab[e * N1];
  load_frames<kSrc>(x + (size_t)b * n_samples, win, xs, t0, n_samples, n_frames, n_fft,
                    hop, shift);
  __syncthreads();

  // Stage 1 and the twiddles: one thread per (k1, n2), n2 fastest.
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k1 = item / N2;
    const int n2 = item - k1 * N2;
    float sr[kFrames], si[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      sr[f] = 0.f;
      si[f] = 0.f;
    }
    int idx = 0;                                   // (n1 k1) mod N1
    const float* xp = xs + n2;
    for (int n1 = 0; n1 < N1; ++n1, xp += N2) {
      const float2 w = tab1[idx];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float v = xp[f * n_fft];
        sr[f] = fmaf(v, w.x, sr[f]);
        si[f] = fmaf(v, w.y, si[f]);
      }
      idx += k1;                                   // k1 < N1, so one wrap suffices
      if (idx >= N1) idx -= N1;
    }
    const float2 tw = tab[n2 * k1];                // n2 k1 < N
    float vr[kFrames], vi[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      vr[f] = sr[f] * tw.x - si[f] * tw.y;
      vi[f] = sr[f] * tw.y + si[f] * tw.x;
    }
    float4* o_r = reinterpret_cast<float4*>(ar + item * kFrames);
    float4* o_i = reinterpret_cast<float4*>(ai + item * kFrames);
    o_r[0] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    o_r[1] = make_float4(vr[4], vr[5], vr[6], vr[7]);
    o_i[0] = make_float4(vi[0], vi[1], vi[2], vi[3]);
    o_i[1] = make_float4(vi[4], vi[5], vi[6], vi[7]);
  }
  __syncthreads();

  // Stage 2: one thread per (k1, k2), k2 fastest.
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k1 = item / N2;
    const int k2 = item - k1 * N2;
    float xr[kFrames], xi[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      xr[f] = 0.f;
      xi[f] = 0.f;
    }
    int idx = 0;                                   // (n2 k2) mod N2
    const float4* ar4 = reinterpret_cast<const float4*>(ar + (size_t)k1 * N2 * kFrames);
    const float4* ai4 = reinterpret_cast<const float4*>(ai + (size_t)k1 * N2 * kFrames);
    for (int n2 = 0; n2 < N2; ++n2) {
      const float2 w = tab2[idx];
      const float4 r0 = ar4[2 * n2], r1 = ar4[2 * n2 + 1];
      const float4 i0 = ai4[2 * n2], i1 = ai4[2 * n2 + 1];
      const float a_r[kFrames] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float a_i[kFrames] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        xr[f] = fmaf(a_r[f], w.x, xr[f]);
        xr[f] = fmaf(-a_i[f], w.y, xr[f]);
        xi[f] = fmaf(a_r[f], w.y, xi[f]);
        xi[f] = fmaf(a_i[f], w.x, xi[f]);
      }
      idx += k2;                                   // k2 < N2, so one wrap suffices
      if (idx >= N2) idx -= N2;
    }
    if (k1 + N1 * k2 < n_bins) {
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        ore[(f * N1 + k1) * S + k2] = xr[f];
        oim[(f * N1 + k1) * S + k2] = xi[f];
      }
    } else if (k1 != 0 && 2 * k1 != N1) {
      // X[N - k] = conj(X[k]), and N - k = (N1 - k1) + N1 (N2 - 1 - k2).
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        ore[(f * N1 + N1 - k1) * S + N2 - 1 - k2] = xr[f];
        oim[(f * N1 + N1 - k1) * S + N2 - 1 - k2] = -xi[f];
      }
    }
  }
  __syncthreads();

  // The block's bins, contiguous in re and im: a coalesced copy.
  const int n_out = min(kFrames, n_frames - t0) * n_bins;
  const size_t o = ((size_t)b * n_frames + t0) * n_bins;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int f = e / n_bins;
    const int k = e - f * n_bins;
    const int src = (f * N1 + k % N1) * S + k / N1;
    const float g = bin_scale<kSrc>(k, n_fft);
    re[o + e] = ore[src] * g;
    im[o + e] = oim[src] * g;
  }
}

template <Src kSrc>
__global__ void stft_direct_kernel(const float* __restrict__ x,
                                   const float* __restrict__ win,
                                   const float2* __restrict__ tab,
                                   float* __restrict__ re, float* __restrict__ im,
                                   int n_samples, int n_frames, int n_fft, int hop,
                                   int shift) {
  extern __shared__ float4 smem4[];
  const int n_bins = n_fft / 2 + 1;
  float2* tab_s = reinterpret_cast<float2*>(smem4);   // [n_fft]
  float* xs = reinterpret_cast<float*>(tab_s + n_fft);   // [kFrames][n_fft], windowed

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;

  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) tab_s[e] = tab[e];
  load_frames<kSrc>(x + (size_t)b * n_samples, win, xs, t0, n_samples, n_frames, n_fft,
                    hop, shift);
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float acc_re[kFrames], acc_im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      acc_re[f] = 0.f;
      acc_im[f] = 0.f;
    }
    int idx = 0;                         // (n * k) mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float2 w = tab_s[idx];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float v = xs[f * n_fft + n];
        acc_re[f] = fmaf(v, w.x, acc_re[f]);
        acc_im[f] = fmaf(v, w.y, acc_im[f]);
      }
      idx += k;                          // k < n_fft, so one wrap suffices
      if (idx >= n_fft) idx -= n_fft;
    }
    const float g = bin_scale<kSrc>(k, n_fft);
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int t = t0 + f;
      if (t < n_frames) {
        const size_t o = ((size_t)b * n_frames + t) * n_bins + k;
        re[o] = acc_re[f] * g;
        im[o] = acc_im[f] * g;
      }
    }
  }
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

template <Src kSrc>
int launch(const float* x, const float* win, const float* tab, float* re, float* im,
           int batch, int n_samples, int n_frames, int n_fft, int hop, int shift, int n1,
           int n2, cudaStream_t stream) {
  if (batch == 0 || n_frames == 0) return 0;
  const int n_bins = n_fft / 2 + 1;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  const float2* tab2 = reinterpret_cast<const float2*>(tab);
  if (n1 == 0) {
    const size_t smem = (size_t)(2 + kFrames) * n_fft * sizeof(float);
    cudaError_t err = allow_smem(stft_direct_kernel<kSrc>, smem);
    if (err != cudaSuccess) return (int)err;
    stft_direct_kernel<kSrc><<<grid, block_threads(n_bins), smem, stream>>>(
        x, win, tab2, re, im, n_samples, n_frames, n_fft, hop, shift);
    return (int)cudaGetLastError();
  }
  if (n1 < 2 || n2 < 2 || n1 * n2 != n_fft) return (int)cudaErrorInvalidValue;
  const int items = (n1 / 2 + 1) * n2;
  const size_t smem = ((size_t)2 * items * kFrames + 2 * (n1 + n2) +
                       (size_t)kFrames * (n_fft + 2 * n1 * (n2 / 2 + 1))) * sizeof(float);
  cudaError_t err = allow_smem(stft_fact_kernel<kSrc>, smem);
  if (err != cudaSuccess) return (int)err;
  stft_fact_kernel<kSrc><<<grid, block_threads(items), smem, stream>>>(
      x, win, tab2, re, im, n_samples, n_frames, n_fft, hop, shift, n1, n2);
  return (int)cudaGetLastError();
}

}  // namespace

// n1 * n2 = n_fft picks the factorised kernel, n1 = 0 the direct sum.  With
// `center` the frames are taken from x reflect-padded by n_fft/2 on both
// sides (n_samples > n_fft/2), through mirrored indices.
extern "C" int aas_stft(const float* x, const float* win, const float* tab,
                        float* re, float* im, int batch, int n_samples,
                        int n_frames, int n_fft, int hop, int center, int n1,
                        int n2, cudaStream_t stream) {
  return launch<Src::kSignal>(x, win, tab, re, im, batch, n_samples, n_frames, n_fft,
                              hop, center ? n_fft / 2 : 0, n1, n2, stream);
}

// The ISTFT's VJP: dy [batch, out_len] (the gradient of aas_istft's trimmed
// output, shift = its center trim) -> (dre, dim) [batch, n_frames,
// n_fft/2+1]; n1, n2 as in aas_stft.  Requires hop | n_fft.
extern "C" int aas_istft_vjp(const float* dy, const float* win, const float* tab,
                             float* dre, float* dim, int batch, int out_len,
                             int n_frames, int n_fft, int hop, int shift, int n1,
                             int n2, cudaStream_t stream) {
  if (hop < 1 || n_fft % hop || shift < 0) return (int)cudaErrorInvalidValue;
  return launch<Src::kIstftGrad>(dy, win, tab, dre, dim, batch, out_len, n_frames,
                                 n_fft, hop, shift, n1, n2, stream);
}
