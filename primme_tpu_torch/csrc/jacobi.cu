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
// parts in the same order) bit for bit. They are instances of the same
// kernel, the element operation the only difference, with 4 n k + 2 n +
// 2 k reals moved, 32-bit row indices and no division by k. A complex
// thread holds 16 bytes of its row group in one row (Shape): two
// complex64 columns, as one float4 where kc, ldx and X's address allow,
// else two float2 loads, or one complex128 column as a double2; kc / that
// many threads share a wider group. The unshifted form takes the guard and
// the complex reciprocal of d[row] (two IEEE divisions, most of an
// element's arithmetic) once for the thread's columns: one reciprocal a
// row for complex64 at k <= 2, where it was one an element.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// The real type of an element, and whether it is complex
template <typename T> struct Real {
  using type = T;
  static constexpr bool kComplex = false;
};
template <> struct Real<float2> {
  using type = float;
  static constexpr bool kComplex = true;
};
template <> struct Real<double2> {
  using type = double;
  static constexpr bool kComplex = true;
};

template <typename T, int W> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float2, 1> { using type = float2; };
template <> struct Vec<float2, 2> { using type = float4; };
template <> struct Vec<double2, 1> { using type = double2; };

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

// The element operations. Shifted: x / guard(d - s). Unshifted: the
// reciprocal of guard(d), once a row, then its product with each x.
template <typename R>
__device__ __forceinline__ R shifted_op(R x, R d, R s, R eps) {
  return div_rn(x, guard(sub_rn(d, s), eps));
}
template <typename R>
__device__ __forceinline__ R reciprocal(R d, R eps) {
  return div_rn(R(1), guard(d, eps));
}
template <typename R>
__device__ __forceinline__ R scale(R inv, R x) {
  return mul_rn(inv, x);
}

// a complex den, eps + 0i where |den| < eps (a NaN stays)
template <typename C, typename R>
__device__ __forceinline__ C cguard(C den, R eps) {
  if (hyp(den.x, den.y) < eps) {
    den.x = eps;
    den.y = R(0);
  }
  return den;
}
template <typename C, typename R>
__device__ __forceinline__ C cshifted(C x, C d, C s, R eps) {
  C den;
  den.x = sub_rn(d.x, s.x);
  den.y = sub_rn(d.y, s.y);
  den = cguard(den, eps);
  C y;
  cdiv(x.x, x.y, den.x, den.y, y.x, y.y);
  return y;
}
template <typename C, typename R>
__device__ __forceinline__ C creciprocal(C d, R eps) {
  const C den = cguard(d, eps);
  C inv;
  cdiv(R(1), R(0), den.x, den.y, inv.x, inv.y);
  return inv;
}
template <typename C>
__device__ __forceinline__ C cscale(C inv, C x) {
  C y;
  y.x = sub_rn(mul_rn(inv.x, x.x), mul_rn(inv.y, x.y));
  y.y = add_rn(mul_rn(inv.x, x.y), mul_rn(inv.y, x.x));
  return y;
}
__device__ __forceinline__ float2 shifted_op(float2 x, float2 d, float2 s,
                                             float eps) {
  return cshifted(x, d, s, eps);
}
__device__ __forceinline__ double2 shifted_op(double2 x, double2 d, double2 s,
                                              double eps) {
  return cshifted(x, d, s, eps);
}
__device__ __forceinline__ float2 reciprocal(float2 d, float eps) {
  return creciprocal(d, eps);
}
__device__ __forceinline__ double2 reciprocal(double2 d, double eps) {
  return creciprocal(d, eps);
}
__device__ __forceinline__ float2 scale(float2 inv, float2 x) {
  return cscale(inv, x);
}
__device__ __forceinline__ double2 scale(double2 inv, double2 x) {
  return cscale(inv, x);
}

// The part of the block a thread takes: kCols columns of its row group
// of KC, loaded VW at a time, in each of kRows rows. A real thread holds
// one vector (16 bytes at most) in four rows. A complex thread holds 16
// bytes of its group (two complex64 columns, as one float4 or two float2
// loads; one complex128 column) in one row: its divisions are many, and
// more threads in flight beat more rows a thread (on an H100 SXM at
// 700 W, 64^3 k=2 complex64 shifted: 0.00495 ms at one row a thread,
// 0.00593 at four; 32 bytes a complex128 thread, two columns to one
// reciprocal, 0.7-1% slower; tools/torch_kernel_variants.py).
template <typename T, int KC, int VW>
struct Shape {
  static constexpr int kCols =
      !Real<T>::kComplex ? VW
                         : (KC < int(16 / sizeof(T)) ? KC
                                                     : int(16 / sizeof(T)));
  static constexpr int kRows = Real<T>::kComplex ? 1 : 4;
};

// kParts = KC / COLS threads share a row, COLS columns each, loaded VW at
// a time, so that a warp's loads and stores cover adjacent memory. A
// block takes ROWS runs of kThreads / kParts adjacent rows; each thread
// loads its ROWS rows before it computes any, so that as many loads are
// in flight.
template <typename T, int KC, int VW, int COLS, int ROWS, bool kShifted>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const T* __restrict__ X, const T* __restrict__ d,
                  const T* __restrict__ sigma, T* __restrict__ Y, int n, int k,
                  long long ldx, typename Real<T>::type eps) {
  constexpr int kParts = KC / COLS;
  constexpr int kRun = kThreads / kParts;  // rows of one run
  const int c = (threadIdx.x % kParts) * COLS;  // the thread's columns
  const int r0 = blockIdx.x * kRun * ROWS + threadIdx.x / kParts;
  T sg[COLS];
  for (int c0 = 0; c0 < k; c0 += KC) {
    T xv[ROWS][COLS], dv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      // a row past the last reads the last and stores nothing
      const int r = min(r0 + u * kRun, n - 1);
      dv[u] = __ldg(d + r);
#pragma unroll
      for (int v = 0; v < COLS; v += VW) {
        ldg_vec<T, VW>(X + static_cast<long long>(r) * ldx + c0 + c + v,
                       xv[u] + v);
      }
    }
    if constexpr (kShifted) {
#pragma unroll
      for (int e = 0; e < COLS; ++e) sg[e] = __ldg(sigma + c0 + c + e);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * kRun;
      if (r >= n) break;
      T yv[COLS];
      if constexpr (kShifted) {
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
          yv[e] = shifted_op(xv[u][e], dv[u], sg[e], eps);
        }
      } else {
        const T inv = reciprocal(dv[u], eps);
#pragma unroll
        for (int e = 0; e < COLS; ++e) yv[e] = scale(inv, xv[u][e]);
      }
#pragma unroll
      for (int v = 0; v < COLS; v += VW) {
        st_vec<T, VW>(Y + static_cast<long long>(r) * k + c0 + c + v, yv + v);
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, long long,
                        typename Real<T>::type);

// A kernel instance and the rows a block of it takes
template <typename T>
struct Launch {
  Kernel<T> fn;
  int rows;
};

template <typename T, int KC, int VW, int COLS, int ROWS, bool kShifted>
Launch<T> instance() {
  return {jacobi_kernel<T, KC, VW, COLS, ROWS, kShifted>,
          kThreads / (KC / COLS) * ROWS};
}

// VW elements of T in one load of at most 16 bytes, VW dividing KC
template <typename T, int KC, int VW>
constexpr bool fits() {
  return KC % VW == 0 && sizeof(T) * VW <= 16;
}

template <typename T, int KC, int VW, bool kShifted>
Launch<T> shaped() {
  using S = Shape<T, KC, VW>;
  return instance<T, KC, VW, S::kCols, S::kRows, kShifted>();
}

template <typename T, int KC, bool kShifted>
Launch<T> pick_vw(int vw) {
  if (vw == 1) return shaped<T, KC, 1, kShifted>();
  if constexpr (fits<T, KC, 2>()) {
    if (vw == 2) return shaped<T, KC, 2, kShifted>();
  }
  if constexpr (fits<T, KC, 4>()) {
    if (vw == 4) return shaped<T, KC, 4, kShifted>();
  }
  return {nullptr, 0};
}

// The instance for row groups of kc columns loaded vw at a time; a null
// kernel for a pair the wrapper never plans.
template <typename T, bool kShifted>
Launch<T> pick(int kc, int vw) {
  switch (kc) {
    case 1: return pick_vw<T, 1, kShifted>(vw);
    case 2: return pick_vw<T, 2, kShifted>(vw);
    case 4: return pick_vw<T, 4, kShifted>(vw);
    case 8: return pick_vw<T, 8, kShifted>(vw);
    default: return {nullptr, 0};
  }
}

template <typename T>
int run(Launch<T> L, const T* X, const T* d, const T* sigma, T* Y, int n,
        int k, long long ldx, typename Real<T>::type eps, int kc, int blocks,
        void* stream) {
  // every row once, with row indices in 32 bits
  if (L.fn == nullptr || n < 1 || k % kc != 0 || ldx < k ||
      blocks != (n + L.rows - 1) / L.rows ||
      static_cast<long long>(blocks) * L.rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  L.fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, d, sigma, Y, n, k, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kShifted>
int launch(const T* X, const T* d, const T* sigma, T* Y, int n, int k,
           long long ldx, typename Real<T>::type eps, int kc, int vw,
           int blocks, void* stream) {
  return run<T>(pick<T, kShifted>(kc, vw), X, d, sigma, Y, n, k, ldx, eps,
                kc, blocks, stream);
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/jacobi.py::plan) plans the launch: kc
// columns a row group, X loaded vw elements at a time, `blocks` blocks of
// 256 threads, as many as the rows need; another grid is refused.
// X [n, k] with rows ldx elements apart, d [n], sigma [k], Y a new
// contiguous [n, k], in the entry point's type (complex: (re, im) pairs).
// Each entry point returns the CUDA error of its launch as an int (0:
// none). The unshifted ones take no sigma.
#define JACOBI_ENTRIES(T, R, SUFFIX)                                         \
  extern "C" int jacobi_shifted_##SUFFIX(const T* X, const T* d,             \
                                         const T* sigma, T* Y, int n, int k, \
                                         long long ldx, R eps, int kc,       \
                                         int vw, int blocks, void* stream) { \
    return launch<T, true>(X, d, sigma, Y, n, k, ldx, eps, kc, vw, blocks,   \
                           stream);                                          \
  }                                                                          \
  extern "C" int jacobi_##SUFFIX(const T* X, const T* d, T* Y, int n, int k, \
                                 long long ldx, R eps, int kc, int vw,       \
                                 int blocks, void* stream) {                 \
    return launch<T, false>(X, d, nullptr, Y, n, k, ldx, eps, kc, vw,        \
                            blocks, stream);                                 \
  }

JACOBI_ENTRIES(float, float, f32)
JACOBI_ENTRIES(double, double, f64)
JACOBI_ENTRIES(float2, float, c64)
JACOBI_ENTRIES(double2, double, c128)
