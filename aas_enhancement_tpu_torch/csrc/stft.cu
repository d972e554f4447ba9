// Windowed real DFT of every frame: the STFT's forward transform.
//
// Replaces: aas_enhancement_tpu/ops/pallas/stft_kernel.py::stft_pallas
// (body _stft_kernel).  The Pallas kernel multiplies hop-wide head/tail rows
// by cos/-sin basis matrices on the MXU; here each block stages a tile of
// windowed frames in shared memory and computes the DFT directly in its own
// body, with the bases taken exactly from a table of cos/-sin(2*pi*m/n_fft)
// indexed by (n*k) mod n_fft.
//
// Bound on the H100: at n_fft = 320, hop = 160 the work is 4 * 161 * 320 FLOPs
// per frame against 640 bytes of new input and 1288 bytes of output, about
// 100 FLOP/byte: far below the tensor-core ridge but above f32 CUDA-core
// balance, so the kernel is bounded by shared-memory reads of the basis table
// (one gather per sample per bin).  Each thread owns one frequency bin and
// keeps kFrames frames' accumulators in registers, so every table read feeds
// 2 * kFrames FMAs and the frame reads are warp-wide broadcasts.
//
// Layout: x [B, n_padded] (already center reflect-padded by the caller),
// win [n_fft], re/im [B, T, n_fft/2+1], all f32 and contiguous.

#include <cuda_runtime.h>

#include "dft_table.cuh"

namespace {

constexpr int kFrames = 8;   // frames per block

__global__ void stft_kernel(const float* __restrict__ x,
                            const float* __restrict__ win,
                            float* __restrict__ re, float* __restrict__ im,
                            int n_padded, int n_frames, int n_fft, int hop,
                            int n_bins) {
  extern __shared__ float smem[];
  float* cos_tab = smem;                 // [n_fft]
  float* nsin_tab = cos_tab + n_fft;     // [n_fft]
  float* frames = nsin_tab + n_fft;      // [kFrames][n_fft], windowed

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* xb = x + (size_t)b * n_padded;

  fill_dft_table(cos_tab, nsin_tab, n_fft);
  for (int e = threadIdx.x; e < kFrames * n_fft; e += blockDim.x) {
    const int tt = e / n_fft;
    const int n = e - tt * n_fft;
    const int t = t0 + tt;
    frames[e] = t < n_frames ? xb[(size_t)t * hop + n] * win[n] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float acc_re[kFrames], acc_im[kFrames];
#pragma unroll
    for (int tt = 0; tt < kFrames; ++tt) {
      acc_re[tt] = 0.f;
      acc_im[tt] = 0.f;
    }
    int idx = 0;                         // (n * k) mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float c = cos_tab[idx];
      const float s = nsin_tab[idx];
#pragma unroll
      for (int tt = 0; tt < kFrames; ++tt) {
        const float v = frames[tt * n_fft + n];
        acc_re[tt] = fmaf(v, c, acc_re[tt]);
        acc_im[tt] = fmaf(v, s, acc_im[tt]);
      }
      idx += k;                          // k < n_fft, so one wrap suffices
      if (idx >= n_fft) idx -= n_fft;
    }
#pragma unroll
    for (int tt = 0; tt < kFrames; ++tt) {
      const int t = t0 + tt;
      if (t < n_frames) {
        const size_t o = ((size_t)b * n_frames + t) * n_bins + k;
        re[o] = acc_re[tt];
        im[o] = acc_im[tt];
      }
    }
  }
}

}  // namespace

extern "C" int aas_stft(const float* x, const float* win, float* re, float* im,
                        int batch, int n_padded, int n_frames, int n_fft,
                        int hop, cudaStream_t stream) {
  if (batch == 0 || n_frames == 0) return 0;
  const int n_bins = n_fft / 2 + 1;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)(2 + kFrames) * n_fft * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  stft_kernel<<<grid, threads, smem, stream>>>(x, win, re, im, n_padded,
                                               n_frames, n_fft, hop, n_bins);
  return (int)cudaGetLastError();
}
