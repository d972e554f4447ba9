// The FFT core of the STFT's and the ISTFT's VJP kernels (csrc/stft_vjp.cu).
//
// A real transform of N = 2M samples runs as an M-point complex FFT over the
// packed even and odd samples (z_m = x[2m] + i x[2m+1]) plus a split step
// with the twiddles W_N^k (the caller's).  The M-point FFT is mixed radix
// (2, 3, 4, 5, 8, 16; the plan comes from ops/cuda/stft.py::vjp_plan) in the
// Stockham form, whose output is in natural order: pass r with span ns (the
// product of the radices before it) takes butterfly j < M/r's inputs at
// j + s M/r (s < r), multiplies input s by W_(ns r)^((j mod ns) s), runs an
// r-point DFT in registers and writes output q at
// (j - j mod ns) r + j mod ns + q ns.  A frame's `lanes` threads share its
// butterflies; between two passes the points go through shared memory, in
// re and im arrays whose index i + (i >> pad_shift) keeps a warp's loads and
// stores on distinct banks (the plan picks the pad that its bank model
// finds cheapest).  Every twiddle is read from the f32 table
// W_N^m = (cos, -sin)(2 pi m / N), m < N, that the host builds in double
// precision (ops/cuda/stft.py::dft_table): W_(ns r)^e = W_N^(e N / (ns r)).
// The inverse direction is conj(FFT(conj z)): the callers conjugate on the
// way in and out, so one set of butterflies serves both.
//
// Also here: cp.async staging of a span of floats into shared memory (16
// bytes a copy where source and destination quads line up, 4 bytes at the
// ragged ends), which the VJP kernels double-buffer.
#pragma once

#include <cuda_runtime.h>

namespace fft {

constexpr int kMaxPasses = 6;

// How a block runs the M-point FFT of its frames (ops/cuda/stft.py::VjpPlan).
struct Plan {
  int radix[kMaxPasses];
  int passes;       // at least 2: pass 0 reads through the caller, the last writes through it
  int m;            // points, n_fft / 2
  int lanes;        // threads a frame
  int frames;       // frames a block transforms at once
  int pad_shift;    // exchange layout: point i at i + (i >> pad_shift) (31: at i)
  int stride;       // floats between two frames' slots of an exchange array
};

__device__ __forceinline__ int slot_index(const Plan& p, int i) { return i + (i >> p.pad_shift); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// W_16^k = (cos, -sin)(2 pi k / 16), k < 8 (W_8^k = W_16^(2k)); k is a
// constant after unrolling, so the switch folds away.
__device__ __forceinline__ float2 w16(int k) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  constexpr float h = 0.70710678118654752f;
  switch (k) {
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s1, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-s1, -c1);
    case 6: return make_float2(-h, -h);
    case 7: return make_float2(-c1, -s1);
    default: return make_float2(1.f, 0.f);
  }
}

// v[O], v[O + S], ..., v[O + (R-1) S] <- their forward R-point DFT, in place
// (X_q = sum_s v_s e^(-2 pi i s q / R)).  8 and 16 split into two halves
// (radix 2, decimation in time).
template <int R, int S = 1, int O = 0>
struct Dft;

template <int S, int O>
struct Dft<2, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = v[O], b = v[O + S];
    v[O] = cadd(a, b);
    v[O + S] = csub(a, b);
  }
};

template <int S, int O>
struct Dft<3, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr float s3 = 0.86602540378443865f;   // sin(2 pi / 3)
    const float2 a = v[O], t = cadd(v[O + S], v[O + 2 * S]), u = csub(v[O + S], v[O + 2 * S]);
    const float2 mid = make_float2(a.x - 0.5f * t.x, a.y - 0.5f * t.y);
    v[O] = cadd(a, t);
    v[O + S] = make_float2(mid.x + s3 * u.y, mid.y - s3 * u.x);
    v[O + 2 * S] = make_float2(mid.x - s3 * u.y, mid.y + s3 * u.x);
  }
};

template <int S, int O>
struct Dft<4, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 t0 = cadd(v[O], v[O + 2 * S]), t1 = csub(v[O], v[O + 2 * S]);
    const float2 t2 = cadd(v[O + S], v[O + 3 * S]);
    const float2 t3 = mul_minus_i(csub(v[O + S], v[O + 3 * S]));
    v[O] = cadd(t0, t2);
    v[O + 2 * S] = csub(t0, t2);
    v[O + S] = cadd(t1, t3);
    v[O + 3 * S] = csub(t1, t3);
  }
};

template <int S, int O>
struct Dft<5, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;   // cos 2pi/5, 4pi/5
    constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;    // sin 2pi/5, 4pi/5
    const float2 a = v[O];
    const float2 t1 = cadd(v[O + S], v[O + 4 * S]), t2 = cadd(v[O + 2 * S], v[O + 3 * S]);
    const float2 t3 = csub(v[O + S], v[O + 4 * S]), t4 = csub(v[O + 2 * S], v[O + 3 * S]);
    const float2 b1 = make_float2(a.x + c1 * t1.x + c2 * t2.x, a.y + c1 * t1.y + c2 * t2.y);
    const float2 b2 = make_float2(a.x + c2 * t1.x + c1 * t2.x, a.y + c2 * t1.y + c1 * t2.y);
    const float2 d1 = mul_minus_i(make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y));
    const float2 d2 = mul_minus_i(make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y));
    v[O] = make_float2(a.x + t1.x + t2.x, a.y + t1.y + t2.y);
    v[O + S] = cadd(b1, d1);
    v[O + 4 * S] = csub(b1, d1);
    v[O + 2 * S] = cadd(b2, d2);
    v[O + 3 * S] = csub(b2, d2);
  }
};

// X_q = E_q + W_2h^q O_q, X_(q+h) = E_q - W_2h^q O_q over the even (E) and
// odd (O) halves, each already transformed in place.
template <int H, int S, int O>
__device__ __forceinline__ void combine_halves(float2* v) {
  float2 e[H], o[H];
#pragma unroll
  for (int q = 0; q < H; ++q) {
    e[q] = v[O + 2 * S * q];
    o[q] = v[O + S + 2 * S * q];
  }
#pragma unroll
  for (int q = 1; q < H; ++q)
    o[q] = 2 * q == H ? mul_minus_i(o[q]) : cmul(o[q], w16(q * (8 / H)));
#pragma unroll
  for (int q = 0; q < H; ++q) {
    v[O + S * q] = cadd(e[q], o[q]);
    v[O + S * (q + H)] = csub(e[q], o[q]);
  }
}

template <int S, int O>
struct Dft<8, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    Dft<4, 2 * S, O>::run(v);
    Dft<4, 2 * S, O + S>::run(v);
    combine_halves<4, S, O>(v);
  }
};

template <int S, int O>
struct Dft<16, S, O> {
  static __device__ __forceinline__ void run(float2* v) {
    Dft<8, 2 * S, O>::run(v);
    Dft<8, 2 * S, O + S>::run(v);
    combine_halves<8, S, O>(v);
  }
};

template <int R>
struct Radix {
  static constexpr int value = R;
};

// f(Radix<r>()) for a radix of the set; other values do nothing (the host
// checks the plan before it launches).
template <class F>
__device__ __forceinline__ void with_radix(int r, F&& f) {
  switch (r) {
    case 2: f(Radix<2>()); break;
    case 3: f(Radix<3>()); break;
    case 4: f(Radix<4>()); break;
    case 5: f(Radix<5>()); break;
    case 8: f(Radix<8>()); break;
    case 16: f(Radix<16>()); break;
    default: break;
  }
}

// One Stockham pass of radix R over a frame's m points, this thread's share
// of the butterflies (j = lane, lane + lanes, ...).  load(i) gives point i,
// store(i, v) takes output i.  tw: the table W_N^m, N = 2 m.
template <int R, class Load, class Store>
__device__ __forceinline__ void pass(int m, int ns, int lane, int lanes,
                                     const float2* __restrict__ tw, Load load, Store store) {
  const int nb = m / R;
  const int step = 2 * m / (ns * R);             // W_(ns R)^1 = W_N^step
  for (int j = lane; j < nb; j += lanes) {
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = load(j + s * nb);
    const int k = j % ns;
    if (k != 0) {
      const int inc = k * step;
      int e = 0;                                   // k s step < N
#pragma unroll
      for (int s = 1; s < R; ++s) {
        e += inc;
        v[s] = cmul(v[s], tw[e]);
      }
    }
    Dft<R>::run(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) store(base + s * ns, v[s]);
  }
}

// The plan's passes over the block's frame slots (slot f = threadIdx.x /
// lanes).  Pass 0 reads point i of slot f as first(f, i); the last pass
// writes output i of slot f through last(f, i, v); pass q < last writes the
// exchange arrays a (q even) or b (q odd), slot f at f * stride, and pass q
// > 0 reads what pass q - 1 wrote.  So the last pass's output belongs in a
// when passes - 1 is even, else in b.  Slots at or past `count` idle.  Every
// thread of the block calls it: it synchronizes the block after each pass.
template <class First, class Last>
__device__ __forceinline__ void run_fft(const Plan& p, const float2* __restrict__ tw,
                                        int count, float* a_re, float* a_im, float* b_re,
                                        float* b_im, First first, Last last) {
  const int f = threadIdx.x / p.lanes;
  const int lane = threadIdx.x - f * p.lanes;
  const int o = f * p.stride;
  int ns = 1;
  for (int q = 0; q < p.passes; ++q) {
    if (f < count) {
      float* w_re = (q & 1) ? b_re : a_re;
      float* w_im = (q & 1) ? b_im : a_im;
      const float* r_re = (q & 1) ? a_re : b_re;
      const float* r_im = (q & 1) ? a_im : b_im;
      auto load_x = [&](int i) {
        const int x = o + slot_index(p, i);
        return make_float2(r_re[x], r_im[x]);
      };
      auto store_x = [&](int i, float2 v) {
        const int x = o + slot_index(p, i);
        w_re[x] = v.x;
        w_im[x] = v.y;
      };
      auto load_first = [&](int i) { return first(f, i); };
      auto store_last = [&](int i, float2 v) { last(f, i, v); };
      const bool is_last = q == p.passes - 1;
      with_radix(p.radix[q], [&](auto rad) {
        constexpr int R = decltype(rad)::value;
        if (q == 0)
          pass<R>(p.m, ns, lane, p.lanes, tw, load_first, store_x);
        else if (is_last)
          pass<R>(p.m, ns, lane, p.lanes, tw, load_x, store_last);
        else
          pass<R>(p.m, ns, lane, p.lanes, tw, load_x, store_x);
      });
    }
    ns *= p.radix[q];
    __syncthreads();
  }
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
  dst[3] = src[3];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most `pending` committed groups of this thread are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

// dst[g - base] = src[g] for lo <= g < hi, issued by the whole block as
// cp.async copies (commit them after).  base is a multiple of 4 and <= lo,
// dst and src are 16-byte aligned, so the quads g = 4j go 16 bytes a copy.
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            long long base, long long lo, long long hi) {
  const long long a = (lo + 3) & ~3LL, e = hi & ~3LL;
  if (a >= e) {
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) cp_async4(dst + (g - base), src + g);
    return;
  }
  for (long long g = lo + threadIdx.x; g < a; g += blockDim.x) cp_async4(dst + (g - base), src + g);
  for (long long g = a + 4 * (long long)threadIdx.x; g < e; g += 4 * (long long)blockDim.x)
    cp_async16(dst + (g - base), src + g);
  for (long long g = e + threadIdx.x; g < hi; g += blockDim.x) cp_async4(dst + (g - base), src + g);
}

}  // namespace fft
