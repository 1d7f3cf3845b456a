// DIA (diagonal storage) product for Hopper (sm_90a), in f32, f64, f16,
// bf16, complex64 and complex128:
//   matmat   y_i = sum_b vals[b, i] * x_{i + off_b}
//   rmatmat  y_i = sum_b conj(vals[b, i - off_b]) * x_{i - off_b}   (A^H)
// on an [n, k] block, a term whose row i + off_b (i - off_b) lies outside
// [0, n) counting as 0.
//
// Replaces the XLA-fused product of primme_tpu/operators.py::
// BandedOperator.matmat/rmatmat (:671-704; the JAX package has no Pallas
// kernel for it, in any type): the banded branch of the format chooser and
// the banded part of its DIA+ELL hybrid run every product through it.
//
// Layout: vals is [B, n] row-indexed (vals[b, i] = A[i, i + off_b], the
// ends of a diagonal padded with anything, usually 0), offs [B] i64 in the
// operator's stored order (not sorted: the sum keeps that order). X is
// [n, k] with rows ldx >= k elements apart (a column slice of the basis
// needs no copy) and adjacent columns; Y is a new contiguous [n, k]. A
// complex element is its real and imaginary parts side by side (float2 or
// double2: torch's complex64 and complex128).
//
// What bounds it: vals is read once (B n sizeof(T) bytes), X and Y once
// each (2 n k sizeof(T)): 2 B k flops (8 B k complex) for B n + 2 n k
// elements, bound by device memory. At 64^3 with the 27 diagonals of a
// 27-point stencil and k=2 in f32 that is 28.3 + 2.1 + 2.1 MB, 9.7 us at
// 3.35 TB/s; the 11 diagonals of the magnetic Laplacian at 64^3 and k=2 in
// complex64 23.1 + 4.2 + 4.2 MB, 9.4 us (both fit the 50 MB L2, so
// repeated calls find them there).
//
// What the design does about that: one thread per (row, column group of
// kc = 8, 4, 2 or 1 columns), rows along the block so that a warp's loads
// of vals[b, i .. i+31] are one line and its B shifted reads of X are
// adjacent rows, served by L1/L2; the offsets are a small device array
// whose loads are the same address across the warp. X is loaded vw
// elements at a time (up to 16 bytes: four f32, two f64 or complex64, one
// complex128; as wide as kc, ldx and X's address allow; the scalar path
// for a slice at an odd column offset). A row off the edge reads the
// thread's own row of X (no load waits on a branch) and counts as 0.
// The arithmetic keeps the plain version's order, one IEEE rounding per
// operation and no fma: out = 0; for each b in stored order
//   out = out + v * x    (matmat: v = vals[b, i], x = 0 off the edge;
//                         rmatmat: v = conj(vals[b, i - off]), and v and x
//                         both 0 off the edge)
// a complex v * x being (vr*xr - vi*xi, vr*xi + vi*xr), each product, the
// difference and the sum rounded once, and out + t adding part by part;
// so the kernel equals its plain PyTorch version (which computes on the
// real and imaginary parts in that order) bit for bit (an off-edge term
// is v * 0 as there, and 0 + -0 is +0 as there). The adjoint conjugates in
// the kernel (a negation, exact): no pass over vals or X. Addresses are
// 64-bit: B n passes 2^31 at B = 256 and n >= 8.4M.
//
// The 16-bit entry points (dia_f16, dia_bf16) serve a half BandedOperator
// (the reference's loop in the half type). Each product and each sum is
// one half operation: taken in f32 on the exact half operands and
// rounded once to the half type, the correctly rounded half result that
// torch's and the JAX package's op-by-op half arithmetic give, so the
// kernel equals its plain version bit for bit here too. A thread loads
// up to eight halves of X's row (16 bytes) at once; the bytes of vals, X
// and Y halve, and so does the bound.
//
// The mixed entry points (dia_f16_f32, dia_bf16_f32, dia_f16_f64,
// dia_bf16_f64) serve a half BandedOperator given a wider real block (a
// half basis hands it f32 blocks), where the reference's product promotes
// to the block's type: each half value is widened (exactly) as it is
// loaded and the sum runs in the block's type, so the result equals the
// f32 (f64) kernel on the widened values bit for bit while vals moves 2
// bytes a value, not 4 (8).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // rows of a block
constexpr int kMaxGridY = 65535;     // CUDA's limit on gridDim.y

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
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
// a half operation: f32 on the exact values, one rounding to the half type
__device__ __forceinline__ __half mul_rn(__half a, __half b) {
  return __float2half_rn(__fmul_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __half add_rn(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __nv_bfloat16 mul_rn(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// a stored value of type V in the block's type T: exact (a half widens)
template <typename T, typename V>
__device__ __forceinline__ T widen(V v) {
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

// The value types: a real scalar, or a complex one as (x, y) = (re, im).
template <typename T> struct Val {
  static __device__ __forceinline__ T zero() { return T(0); }
  static __device__ __forceinline__ T conj(T v) { return v; }
  // acc + v * x, each operation rounded once
  static __device__ __forceinline__ T madd(T acc, T v, T x) {
    return add_rn(acc, mul_rn(v, x));
  }
};
template <typename C> struct CVal {
  static __device__ __forceinline__ C zero() { C z; z.x = 0; z.y = 0; return z; }
  static __device__ __forceinline__ C conj(C v) { v.y = -v.y; return v; }
  static __device__ __forceinline__ C madd(C acc, C v, C x) {
    C out;
    out.x = add_rn(acc.x, sub_rn(mul_rn(v.x, x.x), mul_rn(v.y, x.y)));
    out.y = add_rn(acc.y, add_rn(mul_rn(v.x, x.y), mul_rn(v.y, x.x)));
    return out;
  }
};
template <> struct Val<float2> : CVal<float2> {};
template <> struct Val<double2> : CVal<double2> {};

// W elements of T as one load or store of sizeof(T) * W <= 16 bytes
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

// Thread (x, y) of the grid sums row blockIdx.x * kThreads + threadIdx.x,
// columns [blockIdx.y * KC, + KC), over the B diagonals in stored order;
// the values are stored as V (T, or a half type widened to T).
template <typename T, int KC, int VW, bool kAdjoint, typename V = T>
__global__ void __launch_bounds__(kThreads)
    dia_kernel(const V* __restrict__ vals, const long long* __restrict__ offs,
               int B, const T* __restrict__ X, long long ldx,
               T* __restrict__ Y, int n, int k) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c0 = blockIdx.y * KC;
  using O = Val<T>;
  T acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = O::zero();
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const long long off = __ldg(offs + b);
    const long long j = kAdjoint ? i - off : i + off;
    const bool in = j >= 0 && j < n;
    const long long r = in ? j : i;          // an off-edge row reads row i
    const T v = widen<T>(ldg1(vals + static_cast<long long>(b) * n +
                              (kAdjoint ? r : i)));
    const T* x = X + r * ldx + c0;
    T xv[KC];
#pragma unroll
    for (int c = 0; c < KC; c += VW) ldg_vec<T, VW>(x + c, xv + c);
    // matmat: v * 0 off the edge; rmatmat: conj(v), and 0 * 0 off it
    const T vv = kAdjoint ? (in ? O::conj(v) : O::zero()) : v;
#pragma unroll
    for (int q = 0; q < KC; ++q)
      acc[q] = O::madd(acc[q], vv, in ? xv[q] : O::zero());
  }
  T* y = Y + i * k + c0;
#pragma unroll
  for (int c = 0; c < KC; c += VW) st_vec<T, VW>(y + c, acc + c);
}

template <typename T, typename V = T>
using Kernel = void (*)(const V*, const long long*, int, const T*, long long,
                        T*, int, int);

template <typename T, int KC, bool A, typename V>
Kernel<T, V> pick_vw(int vw) {
  if (vw == 1) return dia_kernel<T, KC, 1, A, V>;
  if constexpr (KC >= 2 && sizeof(T) <= 8) {
    if (vw == 2) return dia_kernel<T, KC, 2, A, V>;
  }
  if constexpr (KC >= 4 && sizeof(T) <= 4) {
    if (vw == 4) return dia_kernel<T, KC, 4, A, V>;
  }
  if constexpr (KC >= 8 && sizeof(T) == 2) {
    if (vw == 8) return dia_kernel<T, KC, 8, A, V>;
  }
  return nullptr;
}

template <typename T, bool A, typename V>
Kernel<T, V> pick_kc(int kc, int vw) {
  switch (kc) {
    case 1: return pick_vw<T, 1, A, V>(vw);
    case 2: return pick_vw<T, 2, A, V>(vw);
    case 4: return pick_vw<T, 4, A, V>(vw);
    case 8: return pick_vw<T, 8, A, V>(vw);
    default: return nullptr;
  }
}

// T: X's and Y's type; V: the values' (T, or a half type)
template <typename T, typename V = T>
int launch(const V* vals, const long long* offs, int B, const T* X,
           long long ldx, T* Y, int n, int k, int adjoint, int kc, int vw,
           int gx, int gy, void* stream) {
  const Kernel<T, V> fn =
      adjoint ? pick_kc<T, true, V>(kc, vw) : pick_kc<T, false, V>(kc, vw);
  // the grid is the wrapper's plan; here only what CUDA and the kernel's
  // instances take
  if (fn == nullptr || B < 1 || n < 1 || k % kc != 0 || ldx < k ||
      gx < 1 || gy < 1 || gy > kMaxGridY ||
      static_cast<long long>(gx) * kThreads < n ||
      static_cast<long long>(gy) * kc != k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fn<<<dim3(gx, gy), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, offs, B, X, ldx, Y, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/dia.py::plan) plans the launch: kc
// columns a thread, X loaded vw elements at a time, gx blocks of 256 rows
// by gy = k / kc column groups. adjoint = 1 computes rmatmat (A^T, or
// A^H for the complex types, whose pointers are to interleaved (re, im)
// pairs). Each entry point returns the CUDA error of its launch as an int
// (0: none). The mixed entry points (dia_<half>_<block>) take half vals
// and X and Y in the block's type.
extern "C" int dia_f32(const float* vals, const long long* offs, int B,
                       const float* X, long long ldx, float* Y, int n, int k,
                       int adjoint, int kc, int vw, int gx, int gy,
                       void* stream) {
  return launch<float>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx, gy,
                       stream);
}

extern "C" int dia_f64(const double* vals, const long long* offs, int B,
                       const double* X, long long ldx, double* Y, int n, int k,
                       int adjoint, int kc, int vw, int gx, int gy,
                       void* stream) {
  return launch<double>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx,
                        gy, stream);
}

extern "C" int dia_f16(const __half* vals, const long long* offs, int B,
                       const __half* X, long long ldx, __half* Y, int n, int k,
                       int adjoint, int kc, int vw, int gx, int gy,
                       void* stream) {
  return launch<__half>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx,
                        gy, stream);
}

extern "C" int dia_bf16(const __nv_bfloat16* vals, const long long* offs,
                        int B, const __nv_bfloat16* X, long long ldx,
                        __nv_bfloat16* Y, int n, int k, int adjoint, int kc,
                        int vw, int gx, int gy, void* stream) {
  return launch<__nv_bfloat16>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc,
                               vw, gx, gy, stream);
}

extern "C" int dia_c64(const float2* vals, const long long* offs, int B,
                       const float2* X, long long ldx, float2* Y, int n, int k,
                       int adjoint, int kc, int vw, int gx, int gy,
                       void* stream) {
  return launch<float2>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx,
                        gy, stream);
}

extern "C" int dia_c128(const double2* vals, const long long* offs, int B,
                        const double2* X, long long ldx, double2* Y, int n,
                        int k, int adjoint, int kc, int vw, int gx, int gy,
                        void* stream) {
  return launch<double2>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx,
                         gy, stream);
}

#define DIA_MIXED(V, T, SUFFIX)                                              \
  extern "C" int dia_##SUFFIX(const V* vals, const long long* offs, int B,  \
                              const T* X, long long ldx, T* Y, int n, int k, \
                              int adjoint, int kc, int vw, int gx, int gy,  \
                              void* stream) {                               \
    return launch<T, V>(vals, offs, B, X, ldx, Y, n, k, adjoint, kc, vw, gx, \
                        gy, stream);                                         \
  }

DIA_MIXED(__half, float, f16_f32)
DIA_MIXED(__nv_bfloat16, float, bf16_f32)
DIA_MIXED(__half, double, f16_f64)
DIA_MIXED(__nv_bfloat16, double, bf16_f64)
#undef DIA_MIXED
