// Real-DFT basis table shared by the STFT and ISTFT kernels.
#pragma once

#include <cuda_runtime.h>

// cos_tab[m] = cos(2*pi*m/n_fft), nsin_tab[m] = -sin(2*pi*m/n_fft), computed
// in double with sincospi so the bases are exact to f32 rounding; a kernel
// reads entry (n*k) mod n_fft for sample n and bin k.  Every thread of the
// block takes part; the caller synchronizes before reading.
__device__ __forceinline__ void fill_dft_table(float* cos_tab, float* nsin_tab,
                                               int n_fft) {
  for (int m = threadIdx.x; m < n_fft; m += blockDim.x) {
    double s, c;
    sincospi(2.0 * m / n_fft, &s, &c);
    cos_tab[m] = (float)c;
    nsin_tab[m] = (float)(-s);
  }
}
