// Shift-aware Jacobi preconditioner apply for Hopper (sm_90a), in f32, f64,
// f16, bf16, complex64 and complex128:
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
//
// The 16-bit entry points (jacobi_shifted_f16/_bf16, jacobi_f16/_bf16)
// serve a half diagonal (the reference's JacobiPrecond over a half
// operator; CastOperator hands it the shifts rounded to the half type).
// Every operation of the reference is one half operation: taken in f32
// on the exact values of its half operands and rounded once to the half
// type, which is the correctly rounded half result (f32 holds more than
// twice a half's digits plus two), the one torch's and the JAX package's
// op-by-op half arithmetic give: den = half(d - s), y = half(x / den);
// inv = half(1 / den), y = half(inv * x). eps is the half it rounds to:
// 1e-10 is 0 in f16, so there a den of exactly 0 is kept and x / 0 is
// an infinity (or NaN), as in the reference; in bf16 it is 1.0e-10. On a
// contiguous block (ldx == k) at a 16-byte aligned address, with k = 1, 2
// or 4, the block is one run of n k halves, and jacobi_run_kernel takes it
// 16 bytes a thread: 8, 4 or 2 whole rows in one load, their diagonal
// entries in one more (half2.cuh's ld_halves), sigma once. It computes two
// lanes a 32-bit word (half2.cuh): den = d - s by one sub.rn.f16x2 /
// bf16x2, the guard on the lanes' magnitude bits (exact; a NaN stays), the
// quotients in f32 by __fdiv_rn on the exact operands and narrowed two at
// a time by one cvt.rn.f16x2.f32 / bf16x2.f32; the unshifted form one
// reciprocal a row, narrowed two at a time, and a packed mul.rn. Each lane
// is the same half operation as before, so the result is unchanged bit
// for bit. (One f32 operation and one narrowing for each half operation,
// with k = 2 rows loaded 4 bytes at a time, ran at 0.21 of the bound at
// 64^3 and 0.78 at 256^3.) A slice (ldx > k), another k or
// an unaligned block keeps jacobi_kernel, up to eight halves (16 bytes)
// of a row group a load.
//
// The mixed entry points (jacobi_shifted_<half>_<block>,
// jacobi_<half>_<block>, block f32 or f64) serve a half diagonal given a
// wider real block and shifts (a half basis hands it f32 ones), where the
// reference's apply promotes: shifted, d widened (exactly) and the rest
// in the block's type, y = x / guard(d - s); unshifted, the reciprocal in
// the half type as above (inv = half(1 / guard(d)), eps the half's), then
// y = inv * x in the block's type. d moves 2 bytes a row. Where an f32
// block has k = 1 or 2, or an f64 block k = 1, on a contiguous, aligned
// block, jacobi_run_kernel takes 16 bytes of X a thread (4 or 2 rows) and
// their rows' d in one load, with the same element operations.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "half2.cuh"

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

// The 16-bit types: each operation in f32 on the exact operands, one
// rounding to the half type; eps is the f32 value of a half.
template <typename H> struct Half;
template <> struct Half<__half> {
  static __device__ __forceinline__ float f(__half a) {
    return __half2float(a);
  }
  static __device__ __forceinline__ __half h(float a) {
    return __float2half_rn(a);
  }
};
template <> struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 a) {
    return __bfloat162float(a);
  }
  static __device__ __forceinline__ __nv_bfloat16 h(float a) {
    return __float2bfloat16_rn(a);
  }
};
#define HALF_OPS(H)                                                       \
  __device__ __forceinline__ H sub_rn(H a, H b) {                         \
    return Half<H>::h(__fsub_rn(Half<H>::f(a), Half<H>::f(b)));           \
  }                                                                       \
  __device__ __forceinline__ H mul_rn(H a, H b) {                         \
    return Half<H>::h(__fmul_rn(Half<H>::f(a), Half<H>::f(b)));           \
  }                                                                       \
  __device__ __forceinline__ H div_rn(H a, H b) {                         \
    return Half<H>::h(__fdiv_rn(Half<H>::f(a), Half<H>::f(b)));           \
  }                                                                       \
  __device__ __forceinline__ H guard(H den, float eps) {                  \
    return fabsf(Half<H>::f(den)) < eps ? Half<H>::h(eps) : den;          \
  }                                                                       \
  __device__ __forceinline__ H shifted_op(H x, H d, H s, float eps) {     \
    return div_rn(x, guard(sub_rn(d, s), eps));                           \
  }                                                                       \
  __device__ __forceinline__ H reciprocal(H d, float eps) {               \
    return div_rn(Half<H>::h(1.0f), guard(d, eps));                       \
  }
HALF_OPS(__half)
HALF_OPS(__nv_bfloat16)
#undef HALF_OPS

// a diagonal entry of type D in the block's type T: exact (a half widens)
template <typename T, typename D>
__device__ __forceinline__ T widen(D v) {
  return v;
}
template <>
__device__ __forceinline__ float widen<float, __half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ double widen<double, __half>(__half v) {
  return static_cast<double>(__half2float(v));
}
template <>
__device__ __forceinline__ double widen<double, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
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
// a half's eps and arithmetic are f32's
template <> struct Real<__half> {
  using type = float;
  static constexpr bool kComplex = false;
};
template <> struct Real<__nv_bfloat16> {
  using type = float;
  static constexpr bool kComplex = false;
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
template <int W> struct Vec16;  // W halves as raw bits
template <> struct Vec16<1> { using type = unsigned short; };
template <> struct Vec16<2> { using type = unsigned int; };
template <> struct Vec16<4> { using type = uint2; };
template <> struct Vec16<8> { using type = uint4; };
template <int W> struct Vec<__half, W> : Vec16<W> {};
template <int W> struct Vec<__nv_bfloat16, W> : Vec16<W> {};

// one element of T, through the read-only path
template <typename T>
__device__ __forceinline__ T ldg1(const T* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ __half ldg1(const __half* p) {
  return __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
template <>
__device__ __forceinline__ __nv_bfloat16 ldg1(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

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
// in flight. d is stored as D: T, or a half type (the mixed entry points).
template <typename T, int KC, int VW, int COLS, int ROWS, bool kShifted,
          typename D = T>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const T* __restrict__ X, const D* __restrict__ d,
                  const T* __restrict__ sigma, T* __restrict__ Y, int n, int k,
                  long long ldx, typename Real<T>::type eps) {
  constexpr int kParts = KC / COLS;
  constexpr int kRun = kThreads / kParts;  // rows of one run
  const int c = (threadIdx.x % kParts) * COLS;  // the thread's columns
  const int r0 = blockIdx.x * kRun * ROWS + threadIdx.x / kParts;
  T sg[COLS];
  for (int c0 = 0; c0 < k; c0 += KC) {
    T xv[ROWS][COLS];
    D dv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      // a row past the last reads the last and stores nothing
      const int r = min(r0 + u * kRun, n - 1);
      dv[u] = ldg1(d + r);
#pragma unroll
      for (int v = 0; v < COLS; v += VW) {
        ldg_vec<T, VW>(X + static_cast<long long>(r) * ldx + c0 + c + v,
                       xv[u] + v);
      }
    }
    if constexpr (kShifted) {
#pragma unroll
      for (int e = 0; e < COLS; ++e) sg[e] = ldg1(sigma + c0 + c + e);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * kRun;
      if (r >= n) break;
      T yv[COLS];
      if constexpr (kShifted) {
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
          yv[e] = shifted_op(xv[u][e], widen<T>(dv[u]), sg[e], eps);
        }
      } else {
        // in D's type: a half reciprocal, then widened
        const T inv = widen<T>(reciprocal(dv[u], eps));
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

// ---------------------------------------------------------------------------
// Runs of adjacent rows: the half and mixed entry points on a contiguous
// block (ldx == k), 16 bytes aligned
// ---------------------------------------------------------------------------

using half2ops::dup;
using half2ops::half_at;
using half2ops::ld_halves;

// the bits of v rounded to the half type H
template <typename H>
__device__ __forceinline__ unsigned short half_bits(float v) {
  if constexpr (std::is_same<H, __half>::value)
    return __half_as_ushort(__float2half_rn(v));
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the bits of the half eps, 0 where no |den| is below eps (eps <= 0, NaN)
template <typename H>
__device__ __forceinline__ unsigned short eps_bits(float eps) {
  return eps > 0.0f ? half_bits<H>(eps) : 0;
}

// guard on both lanes of a word: a lane whose magnitude bits are below
// eb's becomes eb. The bits of a non-negative half order as its values,
// and a NaN's lie above every finite or infinite eb, so this is |den| <
// eps exactly, a NaN kept.
__device__ __forceinline__ unsigned guard2(unsigned den, unsigned short eb) {
  unsigned short lo = static_cast<unsigned short>(den);
  unsigned short hi = static_cast<unsigned short>(den >> 16);
  lo = (lo & 0x7fff) < eb ? eb : lo;
  hi = (hi & 0x7fff) < eb ? eb : hi;
  return half2ops::pack(lo, hi);
}

// x / den on both lanes: each quotient the IEEE f32 one on the exact
// operands (__fdiv_rn, as HALF_OPS' div_rn), both rounded by one narrowing
template <typename H>
__device__ __forceinline__ unsigned div2(unsigned x, unsigned den) {
  using P = half2ops::Packed<H>;
  return P::narrow(__fdiv_rn(P::lo(x), P::lo(den)),
                   __fdiv_rn(P::hi(x), P::hi(den)));
}

template <typename H>
__device__ __forceinline__ H as_half(unsigned short b);
template <>
__device__ __forceinline__ __half as_half<__half>(unsigned short b) {
  return __ushort_as_half(b);
}
template <>
__device__ __forceinline__ __nv_bfloat16 as_half<__nv_bfloat16>(
    unsigned short b) {
  return __ushort_as_bfloat16(b);
}

// Thread t of the grid takes the E = 16 / sizeof(T) elements [E t, E t +
// E) of X's run of n K elements: R = E / K whole rows r0 = R t .., in one
// 16-byte load, and their R diagonal entries in one run of halves
// (ld_halves: one load where r0 keeps it aligned, else aligned words and a
// byte permute). A half block (T = D) computes two lanes a word: den =
// d - s by one sub.rn, the guard on the magnitude bits, the quotients in
// f32 narrowed two at a time (shifted); one reciprocal a row narrowed two
// at a time and a packed mul.rn (unshifted). A wider block (T f32 or f64,
// D half) keeps the element operations of jacobi_kernel. The rows of the
// last thread that pass n are taken element by element, with the scalar
// operations.
template <typename T, typename D, int K, bool kShifted>
__global__ void __launch_bounds__(kThreads)
    jacobi_run_kernel(const T* __restrict__ X, const D* __restrict__ d,
                      const T* __restrict__ sigma, T* __restrict__ Y, int n,
                      int k, long long ldx, typename Real<T>::type eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int R = E / K;
  static_assert(E % K == 0 && R % 2 == 0, "whole rows, an even run of d");
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (r0 >= n) return;
  const unsigned short* dh = reinterpret_cast<const unsigned short*>(d);
  if (r0 + R > n) {
    for (long long r = r0; r < n; ++r) {
      const D dr = ldg1(d + r);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const T x = ldg1(X + r * K + c);
        if constexpr (kShifted) {
          Y[r * K + c] = shifted_op(x, widen<T>(dr), ldg1(sigma + c), eps);
        } else {
          Y[r * K + c] = scale(widen<T>(reciprocal(dr, eps)), x);
        }
      }
    }
    return;
  }
  unsigned dw[R / 2];
  ld_halves<R>(dh + r0, dw);
  if constexpr (std::is_same<T, D>::value) {
    using P = half2ops::Packed<T>;
    const unsigned short eb = eps_bits<T>(eps);
    unsigned xw[4], yw[4];
    half2ops::ld_aligned<8>(
        reinterpret_cast<const unsigned short*>(X) + r0 * K, xw);
    // k = 1: word w is rows 2 w, 2 w + 1; else columns 2 (w % KW), + 1
    // of row w / KW
    constexpr int KW = K == 1 ? 1 : K / 2;
    if constexpr (kShifted) {
      const unsigned short* sh =
          reinterpret_cast<const unsigned short*>(sigma);
      unsigned sw[KW];
      if constexpr (K == 1) {
        sw[0] = dup(__ldg(sh));
      } else {
#pragma unroll
        for (int q = 0; q < KW; ++q)
          sw[q] = half2ops::pack(__ldg(sh + 2 * q), __ldg(sh + 2 * q + 1));
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned dd;
        if constexpr (K == 1) dd = dw[w];
        else dd = dup(half_at(dw, w / KW));
        yw[w] = div2<T>(xw[w], guard2(P::sub(dd, sw[w % KW]), eb));
      }
    } else {
      unsigned iw[R / 2];   // the rows' reciprocals, two a word
      const unsigned one = dup(half_bits<T>(1.0f));
#pragma unroll
      for (int p = 0; p < R / 2; ++p) iw[p] = div2<T>(one, guard2(dw[p], eb));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned inv;
        if constexpr (K == 1) inv = iw[w];
        else inv = dup(half_at(iw, w / KW));
        yw[w] = P::mul(inv, xw[w]);
      }
    }
    half2ops::st_halves<8>(reinterpret_cast<unsigned short*>(Y) + r0 * K,
                           yw);
  } else {
    T xv[E], yv[E];
    ldg_vec<T, E>(X + r0 * K, xv);
    if constexpr (kShifted) {
      T sg[K];
#pragma unroll
      for (int c = 0; c < K; ++c) sg[c] = ldg1(sigma + c);
#pragma unroll
      for (int e = 0; e < E; ++e)
        yv[e] = shifted_op(xv[e], widen<T>(as_half<D>(half_at(dw, e / K))),
                           sg[e % K], eps);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T inv = widen<T>(reciprocal(as_half<D>(half_at(dw, r)), eps));
#pragma unroll
        for (int c = 0; c < K; ++c) yv[r * K + c] = scale(inv, xv[r * K + c]);
      }
    }
    st_vec<T, E>(Y + r0 * K, yv);
  }
}

template <typename T, typename D = T>
using Kernel = void (*)(const T*, const D*, const T*, T*, int, int, long long,
                        typename Real<T>::type);

// A kernel instance and the rows a block of it takes
template <typename T, typename D = T>
struct Launch {
  Kernel<T, D> fn;
  int rows;
};

template <typename T, int KC, int VW, int COLS, int ROWS, bool kShifted,
          typename D = T>
Launch<T, D> instance() {
  return {jacobi_kernel<T, KC, VW, COLS, ROWS, kShifted, D>,
          kThreads / (KC / COLS) * ROWS};
}

// VW elements of T in one load of at most 16 bytes, VW dividing KC
template <typename T, int KC, int VW>
constexpr bool fits() {
  return KC % VW == 0 && sizeof(T) * VW <= 16;
}

template <typename T, int KC, int VW, bool kShifted, typename D>
Launch<T, D> shaped() {
  using S = Shape<T, KC, VW>;
  return instance<T, KC, VW, S::kCols, S::kRows, kShifted, D>();
}

template <typename T, int KC, bool kShifted, typename D>
Launch<T, D> pick_vw(int vw) {
  if (vw == 1) return shaped<T, KC, 1, kShifted, D>();
  if constexpr (fits<T, KC, 2>()) {
    if (vw == 2) return shaped<T, KC, 2, kShifted, D>();
  }
  if constexpr (fits<T, KC, 4>()) {
    if (vw == 4) return shaped<T, KC, 4, kShifted, D>();
  }
  if constexpr (fits<T, KC, 8>()) {
    if (vw == 8) return shaped<T, KC, 8, kShifted, D>();
  }
  return {nullptr, 0};
}

// The instance for row groups of kc columns loaded vw at a time; a null
// kernel for a pair the wrapper never plans.
template <typename T, bool kShifted, typename D>
Launch<T, D> pick(int kc, int vw) {
  switch (kc) {
    case 1: return pick_vw<T, 1, kShifted, D>(vw);
    case 2: return pick_vw<T, 2, kShifted, D>(vw);
    case 4: return pick_vw<T, 4, kShifted, D>(vw);
    case 8: return pick_vw<T, 8, kShifted, D>(vw);
    default: return {nullptr, 0};
  }
}

// The kernels, as the wrapper names them (its `kernel` argument)
enum KernelId : int {
  kRowKernel = 0,   // jacobi_kernel: row groups (every type, any layout)
  kRunKernel = 1,   // jacobi_run_kernel: runs of adjacent rows (a half d;
                    // X contiguous and 16 bytes aligned)
};

// The run instance of k columns, rows 16 / sizeof(T) / k a thread (a null
// kernel where that is not an even number of whole rows, or d is not half)
template <typename T, bool kShifted, typename D>
Launch<T, D> pick_run(int k) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (sizeof(D) == 2) {
    if constexpr (E >= 2 && (E / 2) % 2 == 0) {
      if (k == 2)
        return {jacobi_run_kernel<T, D, 2, kShifted>, kThreads * (E / 2)};
    }
    if constexpr (E >= 4 && (E / 4) % 2 == 0) {
      if (k == 4)
        return {jacobi_run_kernel<T, D, 4, kShifted>, kThreads * (E / 4)};
    }
    if (k == 1) return {jacobi_run_kernel<T, D, 1, kShifted>, kThreads * E};
  }
  return {nullptr, 0};
}

template <typename T, typename D = T>
int run(Launch<T, D> L, const T* X, const D* d, const T* sigma, T* Y, int n,
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

// T: X's, sigma's and Y's type; D: the diagonal's (T, or a half type).
// The run kernel takes a contiguous X (ldx == k == kc) at a 16-byte
// aligned address.
template <typename T, bool kShifted, typename D = T>
int launch(const T* X, const D* d, const T* sigma, T* Y, int n, int k,
           long long ldx, typename Real<T>::type eps, int kernel, int kc,
           int vw, int blocks, void* stream) {
  if (kernel == kRunKernel) {
    if (ldx != k || kc != k || reinterpret_cast<size_t>(X) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return run<T, D>(pick_run<T, kShifted, D>(k), X, d, sigma, Y, n, k, ldx,
                     eps, kc, blocks, stream);
  }
  if (kernel != kRowKernel) return static_cast<int>(cudaErrorInvalidValue);
  return run<T, D>(pick<T, kShifted, D>(kc, vw), X, d, sigma, Y, n, k, ldx,
                   eps, kc, blocks, stream);
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/jacobi.py::plan) plans the launch: the
// kernel (KernelId: the run kernel for a half d on a contiguous, aligned
// block whose k makes an even number of whole rows of 16 bytes, else the
// row-group kernel), kc columns a row group, X loaded vw elements at a
// time, `blocks` blocks of 256 threads, as many as the rows need; another
// grid is refused.
// X [n, k] with rows ldx elements apart, d [n], sigma [k], Y a new
// contiguous [n, k], in the entry point's type (complex: (re, im) pairs).
// Each entry point returns the CUDA error of its launch as an int (0:
// none). The unshifted ones take no sigma.
#define JACOBI_ENTRIES(T, R, SUFFIX)                                         \
  extern "C" int jacobi_shifted_##SUFFIX(const T* X, const T* d,             \
                                         const T* sigma, T* Y, int n, int k, \
                                         long long ldx, R eps, int kernel,   \
                                         int kc, int vw, int blocks,         \
                                         void* stream) {                     \
    return launch<T, true>(X, d, sigma, Y, n, k, ldx, eps, kernel, kc, vw,   \
                           blocks, stream);                                  \
  }                                                                          \
  extern "C" int jacobi_##SUFFIX(const T* X, const T* d, T* Y, int n, int k, \
                                 long long ldx, R eps, int kernel, int kc,   \
                                 int vw, int blocks, void* stream) {         \
    return launch<T, false>(X, d, nullptr, Y, n, k, ldx, eps, kernel, kc,    \
                            vw, blocks, stream);                             \
  }

JACOBI_ENTRIES(float, float, f32)
JACOBI_ENTRIES(double, double, f64)
JACOBI_ENTRIES(__half, float, f16)
JACOBI_ENTRIES(__nv_bfloat16, float, bf16)
JACOBI_ENTRIES(float2, float, c64)
JACOBI_ENTRIES(double2, double, c128)

// The mixed entry points: d in the half type D, X, sigma and Y in T (f32
// or f64), eps in T (the unshifted form's eps the value of the half it
// rounds to)
#define JACOBI_MIXED(T, D, SUFFIX)                                           \
  extern "C" int jacobi_shifted_##SUFFIX(const T* X, const D* d,             \
                                         const T* sigma, T* Y, int n, int k, \
                                         long long ldx, T eps, int kernel,   \
                                         int kc, int vw, int blocks,         \
                                         void* stream) {                     \
    return launch<T, true, D>(X, d, sigma, Y, n, k, ldx, eps, kernel, kc,    \
                              vw, blocks, stream);                           \
  }                                                                          \
  extern "C" int jacobi_##SUFFIX(const T* X, const D* d, T* Y, int n, int k, \
                                 long long ldx, T eps, int kernel, int kc,   \
                                 int vw, int blocks, void* stream) {         \
    return launch<T, false, D>(X, d, nullptr, Y, n, k, ldx, eps, kernel, kc, \
                               vw, blocks, stream);                          \
  }

JACOBI_MIXED(float, __half, f16_f32)
JACOBI_MIXED(float, __nv_bfloat16, bf16_f32)
JACOBI_MIXED(double, __half, f16_f64)
JACOBI_MIXED(double, __nv_bfloat16, bf16_f64)
#undef JACOBI_MIXED
