// Inverse real DFT of every frame, windowed overlap-add and COLA
// normalization: the ISTFT, in gather form.
//
// Replaces: aas_enhancement_tpu/ops/pallas/stft_kernel.py::istft_pallas
// (body _istft_kernel plus the seam add and COLA divide its wrapper does).
// The Pallas kernel computes head/tail halves of each frame as matrix products
// and overlap-adds them with a row roll and a seam row carried across tiles.
// Here every output sample is gathered: sample j of hop-row r sums the
// n_fft/hop frames t = r - q that cover it (at most two at 50% overlap), each
// the inverse rDFT over the n_fft/2+1 bins at frame offset n = q*hop + j,
// times the window; then it is divided by max(sum of window^2, 1e-8).  No
// atomics, no scatter, and each output element is written once.
//
// Bound on the H100: like the forward STFT, about 100 FLOP per byte moved, so
// the kernel is bounded by shared-memory gathers of the basis table.  A block
// stages the (scaled) spectra of the frames its tile of kRows hop-rows needs,
// so every spectrum value is read from device memory once per block; a thread
// owns one sample offset j and keeps kRows accumulators in registers, so one
// table read feeds 2 * kRows FMAs and spectrum reads are broadcasts.
//
// Layout: re/im [B, T, n_fft/2+1], win [n_fft], y [B, (T-1+n_fft/hop)*hop]
// (the full overlap-add buffer; the caller trims the center padding and pads
// to the requested length), all f32 and contiguous.  Requires hop | n_fft.

#include <cuda_runtime.h>

#include "dft_table.cuh"

namespace {

constexpr int kRows = 8;   // hop-rows of output per block

__global__ void istft_kernel(const float* __restrict__ re,
                             const float* __restrict__ im,
                             const float* __restrict__ win,
                             float* __restrict__ y, int n_frames, int n_fft,
                             int hop, int n_bins, int n_rows) {
  extern __shared__ float smem[];
  const int K = n_fft / hop;             // frames covering one sample
  const int nf = kRows + K - 1;          // frames this tile reads
  float* cos_tab = smem;                 // [n_fft]
  float* nsin_tab = cos_tab + n_fft;     // [n_fft]
  float* sre = nsin_tab + n_fft;         // [nf][n_bins], scaled by g_k/n_fft
  float* sim = sre + nf * n_bins;        // [nf][n_bins]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tf0 = r0 - (K - 1);          // frame held in staged slot 0

  fill_dft_table(cos_tab, nsin_tab, n_fft);
  for (int e = threadIdx.x; e < nf * n_bins; e += blockDim.x) {
    const int fi = e / n_bins;
    const int k = e - fi * n_bins;
    const int t = tf0 + fi;
    // Inverse rfft weights: 1 for DC and Nyquist, 2 for the others, / n_fft.
    const float g = ((k == 0 || 2 * k == n_fft) ? 1.f : 2.f) / (float)n_fft;
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
      if (r >= n_rows) continue;
      float wsq = 0.f;                   // COLA: window^2 summed over frames
      for (int q = 0; q < K; ++q) {
        const int t = r - q;
        if (t >= 0 && t < n_frames) {
          const float w = win[q * hop + j];
          wsq += w * w;
        }
      }
      y[((size_t)b * n_rows + r) * hop + j] = out[rr] / fmaxf(wsq, 1e-8f);
    }
  }
}

}  // namespace

extern "C" int aas_istft(const float* re, const float* im, const float* win,
                         float* y, int batch, int n_frames, int n_fft, int hop,
                         cudaStream_t stream) {
  if (batch == 0 || n_frames == 0) return 0;
  const int n_bins = n_fft / 2 + 1;
  const int K = n_fft / hop;
  const int n_rows = n_frames - 1 + K;
  int threads = ((hop + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem =
      (size_t)(2 * n_fft + 2 * (kRows + K - 1) * n_bins) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_rows + kRows - 1) / kRows, batch);
  istft_kernel<<<grid, threads, smem, stream>>>(re, im, win, y, n_frames,
                                                n_fft, hop, n_bins, n_rows);
  return (int)cudaGetLastError();
}
