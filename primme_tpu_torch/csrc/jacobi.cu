// Shift-aware Jacobi preconditioner apply for Hopper (sm_90a), in f32, f64,
// complex64 and complex128:
//   jacobi_shifted_*:  Y[r, c] = X[r, c] / den,  den = d[r] - sigma[c]
//   jacobi_*:          Y[r, c] = (1 / den) * X[r, c],  den = d[r]
// where a den with |den| < eps is replaced by eps (a NaN den stays NaN).
//
// Replaces the XLA-fused ops of primme_tpu/operators.py::JacobiPrecond
// (matmat_shifted, :484-491, and matmat with _safe_inv, :476-482; the JAX
// package has no Pallas kernel for them): every QMR step, every Olsen
// correction and every probe correction of bench.py's headline solve
// preconditions through the shifted entry point.
//
// Layout: X is [n, k], rows ldx >= k elements apart, columns adjacent; d is
// [n], sigma is [k]; Y is a new contiguous [n, k].
//
// What bounds it: X read once, Y written once, d and sigma read once,
// (2 n k + n + k) sizeof(T) bytes for one division per element: bound by
// device memory. At 64^3 and k=2 in f32 that is 5.24 MB, 1.56 us at
// 3.35 TB/s, below the time of a launch; at 256^3 and k=2, 336 MB, 100 us.
//
// What the design does about that:
// - Rows split into vectors: kc = 8, 4, 2 or 1 columns (the largest that
//   divides k; another k loops over k/kc column groups) are read vw at a
//   time (16, 8 or 4 bytes, as wide as kc, ldx and X's address allow; a
//   scalar path otherwise) by kc/vw threads, one vector each: a row of up
//   to 16 bytes is one thread's, all its columns in registers, and a warp
//   reads and writes adjacent memory whatever k is. d[row] is read once
//   per row by each of its threads (one broadcast), sigma once per column
//   group and thread.
// - Four rows a thread, all loaded before any is computed: four rows'
//   loads in flight, in one pass over a grid of n / (4 rows a thread)
//   blocks. No division by k is left (kc/vw is a power of two known at
//   compile time), and 64-bit arithmetic only in the row * ldx address.
//   A one-wave grid with a row loop measured slower at 256^3, so the grid
//   is not one wave.
// The two forms keep the reference's rounding, which differs between
// them: the shifted one is one IEEE division (__fdiv_rn / __ddiv_rn,
// whatever the division flags), the unshifted one a reciprocal and then a
// product. Both compare |den| < eps as the reference does, so a NaN den
// propagates.
//
// The complex entry points (jacobi_shifted_c64/_c128, jacobi_c64/_c128)
// take X, d and sigma complex, each element its real and imaginary parts
// side by side (float2 or double2, torch's complex64 and complex128): the
// reference's complex JacobiPrecond (a complex diagonal, or a real one
// given complex Ritz shifts on the eigs paths). |den| is hypot(re, im),
// and a den under eps becomes eps + 0i. The division is the one of
// torch's complex type (c10::complex's operator/, Smith's two branches on
// |re(den)| >= |im(den)|), the unshifted form's reciprocal that division
// of 1 + 0i followed by a complex product (re: xr*ir - xi*ii, im: xr*ii +
// xi*ir in that order), every operation rounded once and no fma, so the
// kernel equals its plain version (ops/jacobi.py, which computes on the
// parts in the same order) bit for bit. A simple kernel: a thread an
// element of the [n, k] block in a grid-stride loop, X, d and sigma read
// as 8- or 16-byte loads (one complex value each), Y written the same way;
// bound by device memory as the real forms are, with 4 n k + 2 n + 2 k
// reals moved.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread has in flight

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

__device__ __forceinline__ float guard(float den, float eps) {
  return fabsf(den) < eps ? eps : den;
}
__device__ __forceinline__ double guard(double den, double eps) {
  return fabs(den) < eps ? eps : den;
}

template <typename T, int W> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

// W adjacent elements at p (aligned to W elements) into out / from in
template <typename T, int W>
__device__ __forceinline__ void ldg_vec(const T* p, T* out) {
  using V = typename Vec<T, W>::type;
  const V v = __ldg(reinterpret_cast<const V*>(p));
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int c = 0; c < W; ++c) out[c] = e[c];
}
template <typename T, int W>
__device__ __forceinline__ void st_vec(T* p, const T* in) {
  using V = typename Vec<T, W>::type;
  V v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int c = 0; c < W; ++c) e[c] = in[c];
  *reinterpret_cast<V*>(p) = v;
}

// kParts = KC / VW threads share a row, a vector of VW columns each, so that
// a warp's loads and stores cover adjacent memory. A block takes kRows
// runs of kThreads / kParts adjacent rows; each thread loads its kRows
// rows before it computes any, so that as many loads are in flight.
template <typename T, int KC, int VW, bool kShifted>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const T* __restrict__ X, const T* __restrict__ d,
                  const T* __restrict__ sigma, T* __restrict__ Y, int n, int k,
                  long long ldx, T eps) {
  constexpr int kParts = KC / VW;
  constexpr int kRun = kThreads / kParts;  // rows of one run
  const int c = (threadIdx.x % kParts) * VW;  // the thread's columns
  const int r0 = blockIdx.x * kRun * kRows + threadIdx.x / kParts;
  T sg[VW];
  for (int c0 = 0; c0 < k; c0 += KC) {
    T xv[kRows][VW], dv[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      // a row past the last reads the last and stores nothing
      const int r = min(r0 + u * kRun, n - 1);
      dv[u] = __ldg(d + r);
      ldg_vec<T, VW>(X + static_cast<long long>(r) * ldx + c0 + c, xv[u]);
    }
    if constexpr (kShifted) {
#pragma unroll
      for (int e = 0; e < VW; ++e) sg[e] = __ldg(sigma + c0 + c + e);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * kRun;
      if (r >= n) break;
      T yv[VW];
      if constexpr (kShifted) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          yv[e] = div_rn(xv[u][e], guard(sub_rn(dv[u], sg[e]), eps));
        }
      } else {
        const T inv = div_rn(T(1), guard(dv[u], eps));
#pragma unroll
        for (int e = 0; e < VW; ++e) yv[e] = mul_rn(inv, xv[u][e]);
      }
      st_vec<T, VW>(Y + static_cast<long long>(r) * k + c0 + c, yv);
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, long long,
                        T);

template <typename T, int KC, bool kShifted>
Kernel<T> pick_vw(int vw) {
  if (vw == 1) return jacobi_kernel<T, KC, 1, kShifted>;
  if constexpr (KC >= 2) {
    if (vw == 2) return jacobi_kernel<T, KC, 2, kShifted>;
  }
  if constexpr (KC >= 4 && sizeof(T) == 4) {
    if (vw == 4) return jacobi_kernel<T, KC, 4, kShifted>;
  }
  return nullptr;
}

// The instance for kc columns a thread loaded vw at a time; nullptr for a
// pair the wrapper never plans.
template <typename T, bool kShifted>
Kernel<T> pick(int kc, int vw) {
  switch (kc) {
    case 1: return pick_vw<T, 1, kShifted>(vw);
    case 2: return pick_vw<T, 2, kShifted>(vw);
    case 4: return pick_vw<T, 4, kShifted>(vw);
    case 8: return pick_vw<T, 8, kShifted>(vw);
    default: return nullptr;
  }
}

template <typename T, bool kShifted>
int launch(const T* X, const T* d, const T* sigma, T* Y, int n, int k,
           long long ldx, T eps, int kc, int vw, int blocks, void* stream) {
  const Kernel<T> fn = pick<T, kShifted>(kc, vw);
  // every row once, with row indices in 32 bits
  const long long rows = static_cast<long long>(kThreads) / (kc / vw) * kRows;
  if (fn == nullptr || k % kc != 0 || blocks != (n + rows - 1) / rows ||
      blocks * rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, d, sigma, Y, n, k, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}


// ---- complex64 and complex128 -------------------------------------------

template <typename C> struct Real;
template <> struct Real<float2> { using type = float; };
template <> struct Real<double2> { using type = double; };

__device__ __forceinline__ float hyp(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hyp(double a, double b) { return hypot(a, b); }

// (a + i b) / (c + i d) as c10::complex divides: Smith's branch on
// |c| >= |d|, every operation rounded once
template <typename R>
__device__ __forceinline__ void cdiv(R a, R b, R c, R d, R& re, R& im) {
  const R ac = fabs(c), ad = fabs(d);
  if (ac >= ad) {
    if (ac == R(0) && ad == R(0)) {
      re = div_rn(a, ac);
      im = div_rn(b, ad);
    } else {
      const R rat = div_rn(d, c);
      const R scl = div_rn(R(1), add_rn(c, mul_rn(d, rat)));
      re = mul_rn(add_rn(a, mul_rn(b, rat)), scl);
      im = mul_rn(sub_rn(b, mul_rn(a, rat)), scl);
    }
  } else {
    const R rat = div_rn(c, d);
    const R scl = div_rn(R(1), add_rn(d, mul_rn(c, rat)));
    re = mul_rn(add_rn(mul_rn(a, rat), b), scl);
    im = mul_rn(sub_rn(mul_rn(b, rat), a), scl);
  }
}

// Y[r, c] = X[r, c] / guard(d[r] - sigma[c]) (kShifted) or
// (1 / guard(d[r])) * X[r, c], for the n k elements of the block, row by
// row, in a grid-stride loop
template <typename C, bool kShifted>
__global__ void __launch_bounds__(kThreads)
    jacobi_complex_kernel(const C* __restrict__ X, const C* __restrict__ d,
                          const C* __restrict__ sigma, C* __restrict__ Y,
                          long long n, int k, long long ldx,
                          typename Real<C>::type eps) {
  using R = typename Real<C>::type;
  const long long total = n * k;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const long long r = i / k;
    const int c = static_cast<int>(i - r * k);
    const C x = __ldg(X + r * ldx + c);
    C den = __ldg(d + r);
    if constexpr (kShifted) {
      const C s = __ldg(sigma + c);
      den.x = sub_rn(den.x, s.x);
      den.y = sub_rn(den.y, s.y);
    }
    if (hyp(den.x, den.y) < eps) {
      den.x = eps;
      den.y = R(0);
    }
    C y;
    if constexpr (kShifted) {
      cdiv(x.x, x.y, den.x, den.y, y.x, y.y);
    } else {
      R ir, ii;
      cdiv(R(1), R(0), den.x, den.y, ir, ii);
      y.x = sub_rn(mul_rn(ir, x.x), mul_rn(ii, x.y));
      y.y = add_rn(mul_rn(ir, x.y), mul_rn(ii, x.x));
    }
    Y[i] = y;
  }
}

template <typename C, bool kShifted>
int launch_complex(const C* X, const C* d, const C* sigma, C* Y, long long n,
                   int k, long long ldx, typename Real<C>::type eps,
                   int blocks, void* stream) {
  if (n < 1 || k < 1 || ldx < k || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jacobi_complex_kernel<C, kShifted>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          X, d, sigma, Y, n, k, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/jacobi.py) plans the launch: kc columns
// a row group, X loaded vw elements at a time, `blocks` blocks of 256
// threads, as many as the rows need; another grid is refused.
// Each entry point returns the CUDA error of its launch as an int (0:
// none). The unshifted ones take no sigma.
extern "C" int jacobi_shifted_f32(const float* X, const float* d,
                                  const float* sigma, float* Y, int n, int k,
                                  long long ldx, float eps, int kc, int vw,
                                  int blocks, void* stream) {
  return launch<float, true>(X, d, sigma, Y, n, k, ldx, eps, kc, vw, blocks,
                             stream);
}

extern "C" int jacobi_shifted_f64(const double* X, const double* d,
                                  const double* sigma, double* Y, int n, int k,
                                  long long ldx, double eps, int kc, int vw,
                                  int blocks, void* stream) {
  return launch<double, true>(X, d, sigma, Y, n, k, ldx, eps, kc, vw, blocks,
                              stream);
}

extern "C" int jacobi_f32(const float* X, const float* d, float* Y, int n,
                          int k, long long ldx, float eps, int kc, int vw,
                          int blocks, void* stream) {
  return launch<float, false>(X, d, nullptr, Y, n, k, ldx, eps, kc, vw, blocks,
                              stream);
}

extern "C" int jacobi_f64(const double* X, const double* d, double* Y, int n,
                          int k, long long ldx, double eps, int kc, int vw,
                          int blocks, void* stream) {
  return launch<double, false>(X, d, nullptr, Y, n, k, ldx, eps, kc, vw,
                               blocks, stream);
}

// The complex entry points: X [n, k] with rows ldx complex elements apart,
// d [n], sigma [k], Y a new contiguous [n, k]; `blocks` blocks of 256
// threads walk the n k elements (the wrapper plans it). Each returns the
// CUDA error of its launch as an int (0: none).
extern "C" int jacobi_shifted_c64(const float2* X, const float2* d,
                                  const float2* sigma, float2* Y, long long n,
                                  int k, long long ldx, float eps, int blocks,
                                  void* stream) {
  return launch_complex<float2, true>(X, d, sigma, Y, n, k, ldx, eps, blocks,
                                      stream);
}

extern "C" int jacobi_shifted_c128(const double2* X, const double2* d,
                                   const double2* sigma, double2* Y,
                                   long long n, int k, long long ldx,
                                   double eps, int blocks, void* stream) {
  return launch_complex<double2, true>(X, d, sigma, Y, n, k, ldx, eps, blocks,
                                       stream);
}

extern "C" int jacobi_c64(const float2* X, const float2* d, float2* Y,
                          long long n, int k, long long ldx, float eps,
                          int blocks, void* stream) {
  return launch_complex<float2, false>(X, d, nullptr, Y, n, k, ldx, eps,
                                       blocks, stream);
}

extern "C" int jacobi_c128(const double2* X, const double2* d, double2* Y,
                           long long n, int k, long long ldx, double eps,
                           int blocks, void* stream) {
  return launch_complex<double2, false>(X, d, nullptr, Y, n, k, ldx, eps,
                                        blocks, stream);
}
