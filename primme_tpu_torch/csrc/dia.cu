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
// one half operation, and the kernels take it packed: two lanes of one
// mul.rn / add.rn f16x2 or bf16x2 instruction (half2.cuh), the correctly
// rounded half result that torch's and the JAX package's op-by-op half
// arithmetic give, so the kernel equals its plain version bit for bit
// here too. (Taking each half operation in f32 on the widened operands
// and narrowing it costs two widenings and one narrowing an operation,
// the narrowing on the slow conversion pipe: slower than the f32 kernel
// on half the bytes.) A thread sums two rows
// 32 apart (dia_half_kernel), so that each load of a row stays one
// warp-wide run while the offset's load and index arithmetic serve two
// rows; a packed pair is two columns of a row (kc >= 2: the row's value
// on both lanes) or, at kc = 1, the thread's two rows. With X one column
// (ldx = 1) a thread sums four adjacent rows instead (dia_run_kernel):
// a diagonal's four values and the four shifted rows of X each arrive as
// one run of halves, one load where the shift keeps the run aligned, and
// aligned words put together with a byte permute where an odd offset (or
// vals' rows at an odd n) puts it at an odd half; the arithmetic stays
// packed, and a thread stages four diagonals' loads before it sums them.
// On one column of the 27-point Laplacian it runs 1.18x dia_half_kernel
// at 256^3 and 1.03x at 64^3 (tools/torch_kernel_turns.py, in turns;
// NVIDIA H100 80GB HBM3, 700.00 W). (Adjacent rows for every shape lost
// at k >= 2: a thread's rows of X then lie ldx apart, so a warp's load of
// one row spreads over twice the sectors.) Off the edge both keep the f32
// kernel's rule: v * 0 for matmat, 0 * 0 for rmatmat.
//
// The mixed entry points (dia_f16_f32, dia_bf16_f32, dia_f16_f64,
// dia_bf16_f64) serve a half BandedOperator given a wider real block (a
// half basis hands it f32 blocks), where the reference's product promotes
// to the block's type: each half value is widened (exactly) as it is
// loaded and the sum runs in the block's type, so the result equals the
// f32 (f64) kernel on the widened values bit for bit while vals moves 2
// bytes a value, not 4 (8). On dia_kernel, that moved 0.57x dia_f32's
// bytes in 0.97x its time at 64^3 k=2 (27 diagonals): each diagonal and
// row costs an 8-byte offset load and 64-bit index arithmetic besides its
// value and row of X. dia_mixed_kernel keeps dia_kernel's thread map (one
// row a thread, a warp's loads of vals and of X each one run) and its
// arithmetic, stages the offsets once a block in shared memory as 32-bit
// row shifts, and issues the loads of nine diagonals (four at kc >= 4)
// before it sums any of them. (Runs of adjacent rows a thread, their
// values in one load and their rows of X in 16-byte chunks, measured
// slower at 64^3, where the solves run, two rows also at 256^3, four rows
// faster there: tools/torch_mixed_dia_variants.py.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "half2.cuh"

namespace {

constexpr int kThreads = 256;        // threads of a block
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
// the values are stored as V (T, or a half type widened to T: the mixed
// entry points). f32, f64, complex64 and complex128 blocks.
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

// ---------------------------------------------------------------------------
// Half values and a half block: packed sums
// ---------------------------------------------------------------------------

using half2ops::half_at;
using half2ops::ld_halves;
using half2ops::ld_row;
using half2ops::pack;
using half2ops::st_halves;


// Rows 32 apart: thread (x, y) of warp w sums rows i0 + 32 r, r < R, with
// i0 = (blockIdx.x kThreads + 32 w) R + lane, columns [blockIdx.y KC, +
// KC), over the B diagonals in stored order, so that a load of one row is
// one warp-wide run, as in dia_kernel, while the offset and its index
// arithmetic serve R rows. A packed pair is two columns of a row (KC >= 2:
// the row's value on both lanes) or, at KC = 1, rows i0 + 64 p and i0 +
// 64 p + 32.
template <typename H, int KC, int VW, int R, bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
    dia_half_kernel(const H* __restrict__ vals,
                    const long long* __restrict__ offs, int B,
                    const H* __restrict__ X, long long ldx, H* __restrict__ Y,
                    int n, int k) {
  static_assert(KC >= 2 || R % 2 == 0,
                "a packed pair is two columns or two rows");
  constexpr int kAW = KC == 1 ? R / 2 : R * KC / 2;   // words of the sums
  using P = half2ops::Packed<H>;
  const int lane = threadIdx.x % 32;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - lane) *
          R + lane;
  if (i0 >= n) return;
  const int c0 = blockIdx.y * KC;
  const unsigned short* V = reinterpret_cast<const unsigned short*>(vals);
  const unsigned short* Xh = reinterpret_cast<const unsigned short*>(X);
  unsigned acc[kAW];
#pragma unroll
  for (int p = 0; p < kAW; ++p) acc[p] = 0u;   // +0 on both lanes
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const long long off = __ldg(offs + b);
    const unsigned short* vb = V + static_cast<long long>(b) * n;
    unsigned short v[R];
    unsigned xw[KC >= 2 ? R * KC / 2 : 1];
    unsigned short xh[KC == 1 ? R : 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // a row past n reads row n - 1 (its sum is not stored)
      const long long i = i0 + 32 * r < n ? i0 + 32 * r : n - 1;
      const long long j = kAdjoint ? i - off : i + off;
      const bool in = i0 + 32 * r < n && j >= 0 && j < n;
      const long long src = in ? j : i;      // an off-edge row reads row i
      const unsigned short vv = __ldg(vb + (kAdjoint ? src : i));
      // matmat: v * 0 off the edge; rmatmat: 0 * 0
      v[r] = kAdjoint && !in ? 0 : vv;
      if constexpr (KC >= 2) {
        ld_row<KC, VW>(Xh + src * ldx + c0, xw + r * (KC / 2));
#pragma unroll
        for (int q = 0; q < KC / 2; ++q)
          xw[r * (KC / 2) + q] = in ? xw[r * (KC / 2) + q] : 0u;
      } else {
        const unsigned short x = __ldg(Xh + src * ldx + c0);
        xh[r] = in ? x : 0;
      }
    }
    if constexpr (KC >= 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned v2 = pack(v[r], v[r]);
#pragma unroll
        for (int q = 0; q < KC / 2; ++q)
          acc[r * (KC / 2) + q] = P::add(acc[r * (KC / 2) + q],
                                         P::mul(v2, xw[r * (KC / 2) + q]));
      }
    } else {
#pragma unroll
      for (int p = 0; p < R / 2; ++p)
        acc[p] = P::add(acc[p], P::mul(pack(v[2 * p], v[2 * p + 1]),
                                       pack(xh[2 * p], xh[2 * p + 1])));
    }
  }
  unsigned short* y = reinterpret_cast<unsigned short*>(Y);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + 32 * r;
    if (i >= n) break;
    if constexpr (KC >= 2) {
      st_halves<KC>(y + i * k + c0, acc + r * (KC / 2));
    } else {
      y[i * k + c0] = half_at(acc, r);
    }
  }
}

// Diagonal b's values for the R adjacent rows i0 .. i0 + R - 1 of a thread
// of dia_run_kernel, as R / 2 words: vals[b, i] for matmat, vals[b, i -
// off] for rmatmat, 0 for rmatmat where that row is off the edge. `full`:
// every row < n and every shifted row inside [0, n): one run; else row by
// row, a row past n reading row n - 1 (its sum is never stored).
template <int R, bool kAdjoint>
__device__ __forceinline__ void stage_vals(const unsigned short* V,
                                           long long i0, long long j0, int n,
                                           bool full, unsigned* w) {
  if (full) {
    ld_halves<R>(V + (kAdjoint ? j0 : i0), w);
    return;
  }
  unsigned short h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + r < n ? i0 + r : n - 1;
    const long long j = j0 + r;
    const bool in = i0 + r < n && j >= 0 && j < n;
    const unsigned short v = __ldg(V + (kAdjoint && in ? j : i));
    h[r] = kAdjoint && !in ? 0 : v;
  }
#pragma unroll
  for (int p = 0; p < R / 2; ++p) w[p] = pack(h[2 * p], h[2 * p + 1]);
}

// The same rows of X, one column (ldx = 1): one run of R halves; at the
// edges row by row, an off-edge row 0.
template <int R>
__device__ __forceinline__ void stage_x_run(const unsigned short* X,
                                            long long i0, long long j0,
                                            int n, bool full, unsigned* w) {
  if (full) {
    ld_halves<R>(X + j0, w);
    return;
  }
  unsigned short h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j = j0 + r;
    const bool in = i0 + r < n && j >= 0 && j < n;
    const unsigned short x = __ldg(X + (in ? j : (i0 + r < n ? i0 + r
                                                              : n - 1)));
    h[r] = in ? x : 0;
  }
#pragma unroll
  for (int p = 0; p < R / 2; ++p) w[p] = pack(h[2 * p], h[2 * p + 1]);
}

// One column of X (ldx = 1): thread t of the grid sums the R adjacent rows
// [R t, R t + R), the pairs (R t + 2 p, R t + 2 p + 1), so that a
// diagonal's R values and the R shifted rows of X each arrive as one run
// (ld_halves: one load where the shift keeps the run aligned, aligned
// words and a byte permute where it puts it at an odd half). The loads of
// kU diagonals are staged before any is summed, so that they are in
// flight at once.
template <typename H, int R, bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
    dia_run_kernel(const H* __restrict__ vals,
                   const long long* __restrict__ offs, int B,
                   const H* __restrict__ X, long long ldx, H* __restrict__ Y,
                   int n, int k) {
  static_assert(R % 2 == 0, "a packed pair is two rows");
  constexpr int kU = 4;
  using P = half2ops::Packed<H>;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (i0 >= n) return;
  const bool rows_in = i0 + R <= n;
  const unsigned short* V = reinterpret_cast<const unsigned short*>(vals);
  const unsigned short* Xh = reinterpret_cast<const unsigned short*>(X);
  unsigned acc[R / 2];
#pragma unroll
  for (int p = 0; p < R / 2; ++p) acc[p] = 0u;   // +0 on both lanes
  for (int b0 = 0; b0 < B; b0 += kU) {
    unsigned vw[kU][R / 2], xw[kU][R / 2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (b0 + u < B) {
        const long long off = __ldg(offs + b0 + u);
        const long long j0 = kAdjoint ? i0 - off : i0 + off;
        const bool full = rows_in && j0 >= 0 && j0 + R <= n;
        stage_vals<R, kAdjoint>(V + static_cast<long long>(b0 + u) * n, i0,
                                j0, n, full, vw[u]);
        stage_x_run<R>(Xh, i0, j0, n, full, xw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (b0 + u < B) {
#pragma unroll
        for (int p = 0; p < R / 2; ++p)
          acc[p] = P::add(acc[p], P::mul(vw[u][p], xw[u][p]));
      }
    }
  }
  unsigned short* y = reinterpret_cast<unsigned short*>(Y);
  if (rows_in) {
    st_halves<R>(y + i0, acc);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r < n) y[i0 + r] = half_at(acc, r);
  }
}

// ---------------------------------------------------------------------------
// Half values and a wider block (f32, f64): runs of adjacent rows
// ---------------------------------------------------------------------------

// the f32 (f64) value of the half bits h
template <typename T, typename H>
__device__ __forceinline__ T widen_bits(unsigned short h) {
  if constexpr (std::is_same<H, __half>::value)
    return widen<T>(__ushort_as_half(h));
  else
    return widen<T>(__ushort_as_bfloat16(h));
}

// U diagonals of dia_mixed_kernel at once, their row shifts at sh and
// their values of row i at vt, U * n apart: the U loads of a value and a
// row of X (rows ld elements apart; kDense: KC), then the U sums. Only the
// first `left` slots are diagonals (kWhole: all U); a slot past them loads
// its last diagonal again and adds 0 * 0 = +0, which leaves every sum as
// it is (a sum is never -0: it starts at +0, and x + -x is +0), so no
// load waits on a branch.
template <int U, bool kWhole, bool kDense, typename H, typename T, int KC,
          int VW, bool kAdjoint>
__device__ __forceinline__ void mixed_group(const unsigned short* vt,
                                            const int* sh, int i, int n,
                                            const T* Xc, int ld, T* acc,
                                            int left) {
  T v[U], x[U][KC];
  bool in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool real = kWhole || u < left;
    const int us = kWhole || u < left ? u : left - 1;
    const int j = kAdjoint ? i - sh[us] : i + sh[us];
    in[u] = real && static_cast<unsigned>(j) < static_cast<unsigned>(n);
    const int r = in[u] ? j : i;         // an off-edge row reads row i
    const T val = widen_bits<T, H>(__ldg(vt + static_cast<long long>(us) * n
                                         + (kAdjoint ? r - i : 0)));
    v[u] = real ? val : T(0);
    const T* xr = Xc + static_cast<long long>(r) * (kDense ? KC : ld);
#pragma unroll
    for (int c = 0; c < KC; c += VW) ldg_vec<T, VW>(xr + c, x[u] + c);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    // matmat: v * 0 off the edge; rmatmat: 0 * 0
    const T vv = kAdjoint && !in[u] ? T(0) : v[u];
#pragma unroll
    for (int q = 0; q < KC; ++q)
      acc[q] = add_rn(acc[q], mul_rn(vv, in[u] ? x[u][q] : T(0)));
  }
}

// The mixed kernel's staged diagonals and the most offsets its shared
// memory takes (48 KB, the default limit of a block's dynamic shared
// memory)
template <int KC> struct MixedGroup {
  static constexpr int kU = KC <= 2 ? 9 : 4;
};
constexpr int kMixedMaxB = 12288;

// Half values H and a block in T (f32 or f64): dia_kernel's thread map
// (thread (x, y) sums row blockIdx.x * kThreads + threadIdx.x, columns
// [blockIdx.y KC, + KC), loaded VW at a time, so that a warp's loads of
// vals and of X are each one run), with the B offsets staged once a block
// in shared memory as 32-bit row shifts clamped to [-n, n] (a shift of n
// or more leaves every row off the edge, as the 64-bit one does; n < 2^30
// keeps every row index in 32 bits, and a row stride under 2^31 each
// row's offset one 32 x 32-bit product; B <= kMixedMaxB), and the loads of
// kU diagonals (9, or 4 at KC >= 4: a value and a row of X each) issued
// before any of them is summed (kDense: a contiguous block of one column
// group, its rows KC apart at compile time). The arithmetic is
// dia_kernel's: widened values, one rounding an operation in T in stored
// order, no fma, v * 0 off the edge for matmat and 0 * 0 for rmatmat.
template <typename H, typename T, int KC, int VW, bool kAdjoint,
          bool kDense = false>
__global__ void __launch_bounds__(kThreads)
    dia_mixed_kernel(const H* __restrict__ vals,
                     const long long* __restrict__ offs, int B,
                     const T* __restrict__ X, long long ldx,
                     T* __restrict__ Y, int n, int k) {
  constexpr int kU = MixedGroup<KC>::kU;
  extern __shared__ int shift[];        // B row shifts
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const long long o = __ldg(offs + b);
    shift[b] = static_cast<int>(o < -n ? -n : o > n ? n : o);
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ld = static_cast<int>(ldx);          // the launch checks it fits
  const T* Xc = X + blockIdx.y * KC;
  // row i of diagonal b: matmat's value (rmatmat's is row j's)
  const unsigned short* vt = reinterpret_cast<const unsigned short*>(vals) + i;
  T acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = T(0);
  // kU diagonals at a time; the last group's empty slots add +0
  int b = 0;
  for (; b + kU <= B; b += kU)
    mixed_group<kU, true, kDense, H, T, KC, VW, kAdjoint>(
        vt + static_cast<long long>(b) * n, shift + b, i, n, Xc, ld, acc, kU);
  if (b < B)
    mixed_group<kU, false, kDense, H, T, KC, VW, kAdjoint>(
        vt + static_cast<long long>(b) * n, shift + b, i, n, Xc, ld, acc,
        B - b);
  T* y = Y + static_cast<long long>(i) * k + blockIdx.y * KC;
#pragma unroll
  for (int c = 0; c < KC; c += VW) st_vec<T, VW>(y + c, acc + c);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The kernels, as the wrapper names them (its `kernel` argument)
enum KernelId : int {
  kRowKernel = 0,    // dia_kernel: one row a thread (f32, f64, complex;
                     // mixed past kMixedMaxN rows)
  kHalfKernel = 1,   // dia_half_kernel: kHalfRows rows 32 apart (half block)
  kRunKernel = 2,    // dia_run_kernel: vw = kRunRows adjacent rows (half
                     // block, X one column)
  kMixedKernel = 3,  // dia_mixed_kernel: one row a thread, offsets staged
                     // (half values, f32 or f64 block)
};
constexpr int kMixedMaxN = 1 << 30;   // the mixed kernel's 32-bit rows
constexpr int kHalfRows = 2;      // rows of a dia_half_kernel thread
constexpr int kRunRows = 4;       // rows of a dia_run_kernel thread

template <typename T, typename V>
using Kernel = void (*)(const V*, const long long*, int, const T*, long long,
                        T*, int, int);

// the instance of (kc, vw) of dia_kernel (f32, f64, complex; mixed past
// kMixedMaxN rows)
template <typename T, typename V, int KC, bool A>
Kernel<T, V> pick_vw(int vw) {
  if (vw == 1) return dia_kernel<T, KC, 1, A, V>;
  if constexpr (KC >= 2 && sizeof(T) <= 8) {
    if (vw == 2) return dia_kernel<T, KC, 2, A, V>;
  }
  if constexpr (KC >= 4 && sizeof(T) <= 4) {
    if (vw == 4) return dia_kernel<T, KC, 4, A, V>;
  }
  return nullptr;
}

// the instance of (kc, vw) of dia_half_kernel
template <typename H, int KC, bool A>
Kernel<H, H> pick_half_vw(int vw) {
  if (vw == 1) return dia_half_kernel<H, KC, 1, kHalfRows, A>;
  if constexpr (KC >= 2) {
    if (vw == 2) return dia_half_kernel<H, KC, 2, kHalfRows, A>;
  }
  if constexpr (KC >= 4) {
    if (vw == 4) return dia_half_kernel<H, KC, 4, kHalfRows, A>;
  }
  if constexpr (KC >= 8) {
    if (vw == 8) return dia_half_kernel<H, KC, 8, kHalfRows, A>;
  }
  return nullptr;
}

// the instance of (kc, vw) of dia_mixed_kernel (half values, f32 or f64
// block)
template <typename T, typename H, int KC, bool A>
Kernel<T, H> pick_mixed_vw(int vw) {
  if (vw == 1) return dia_mixed_kernel<H, T, KC, 1, A>;
  if constexpr (KC >= 2 && sizeof(T) <= 8) {
    if (vw == 2) return dia_mixed_kernel<H, T, KC, 2, A>;
  }
  if constexpr (KC >= 4 && sizeof(T) <= 4) {
    if (vw == 4) return dia_mixed_kernel<H, T, KC, 4, A>;
  }
  return nullptr;
}

template <typename T, typename H, bool A>
Kernel<T, H> pick_mixed(int kc, int vw, bool dense) {
  // a contiguous block of one column group: the rows' stride known here
  if (dense && kc == 1 && vw == 1)
    return dia_mixed_kernel<H, T, 1, 1, A, true>;
  if (dense && kc == 2 && vw == 2)
    return dia_mixed_kernel<H, T, 2, 2, A, true>;
  switch (kc) {
    case 1: return pick_mixed_vw<T, H, 1, A>(vw);
    case 2: return pick_mixed_vw<T, H, 2, A>(vw);
    case 4: return pick_mixed_vw<T, H, 4, A>(vw);
    case 8: return pick_mixed_vw<T, H, 8, A>(vw);
    default: return nullptr;
  }
}

// The instance of (kernel, kc, vw), nullptr for one that does not exist:
// dia_kernel for the f32, f64, complex and mixed entry points, the mixed
// kernel for the mixed ones, the half kernels for a half block.
template <typename T, typename V, bool A>
Kernel<T, V> pick(int kernel, int kc, int vw, bool dense) {
  constexpr bool kHalf = std::is_same<T, V>::value && sizeof(T) == 2;
  if constexpr (kHalf) {
    if (kernel == kRunKernel)
      return kc == 1 && vw == kRunRows ? dia_run_kernel<T, kRunRows, A>
                                       : nullptr;
    if (kernel != kHalfKernel) return nullptr;
  } else {
    if constexpr (sizeof(V) == 2 && (std::is_same<T, float>::value ||
                                     std::is_same<T, double>::value)) {
      if (kernel == kMixedKernel) return pick_mixed<T, V, A>(kc, vw, dense);
    }
    if (kernel != kRowKernel) return nullptr;
  }
  switch (kc) {
    case 1:
      if constexpr (kHalf) return pick_half_vw<T, 1, A>(vw);
      else return pick_vw<T, V, 1, A>(vw);
    case 2:
      if constexpr (kHalf) return pick_half_vw<T, 2, A>(vw);
      else return pick_vw<T, V, 2, A>(vw);
    case 4:
      if constexpr (kHalf) return pick_half_vw<T, 4, A>(vw);
      else return pick_vw<T, V, 4, A>(vw);
    case 8:
      if constexpr (kHalf) return pick_half_vw<T, 8, A>(vw);
      else return pick_vw<T, V, 8, A>(vw);
    default: return nullptr;
  }
}

// T: X's and Y's type; V: the values' (T, or a half type)
template <typename T, typename V = T>
int launch(const V* vals, const long long* offs, int B, const T* X,
           long long ldx, T* Y, int n, int k, int adjoint, int kernel, int kc,
           int vw, int gx, int gy, void* stream) {
  const bool dense = ldx == k && k == kc;
  const Kernel<T, V> fn = adjoint ? pick<T, V, true>(kernel, kc, vw, dense)
                                  : pick<T, V, false>(kernel, kc, vw, dense);
  // the grid is the wrapper's plan; here only what CUDA and the kernel's
  // instances take: X's vector loads aligned, the run kernel's X one
  // column, the mixed kernel's rows and row stride in 32 bits and its
  // offsets in shared memory
  const size_t xa = reinterpret_cast<size_t>(X);
  const bool run = kernel == kRunKernel;
  const int rows = run ? kRunRows : kernel == kHalfKernel ? kHalfRows : 1;
  if (fn == nullptr || B < 1 || n < 1 || k % kc != 0 || ldx < k ||
      gx < 1 || gy < 1 || gy > kMaxGridY ||
      static_cast<long long>(gx) * kThreads * rows < n ||
      static_cast<long long>(gy) * kc != k ||
      (kernel == kMixedKernel &&
       (n >= kMixedMaxN || ldx > 0x7fffffffLL || B > kMixedMaxB)) ||
      (run ? ldx != 1
           : (ldx % vw != 0 || xa % (static_cast<size_t>(vw) * sizeof(T))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the mixed kernel's row shifts: B ints of dynamic shared memory
  const size_t smem = kernel == kMixedKernel ? sizeof(int) * B : 0;
  fn<<<dim3(gx, gy), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, offs, B, X, ldx, Y, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/dia.py::plan) plans the launch: the
// kernel (KernelId: dia_kernel for the f32, f64 and complex entry points;
// dia_mixed_kernel for the mixed ones; for a half block the run kernel
// where X is one column, else dia_half_kernel), kc columns a thread, X
// loaded vw elements at a time (the run kernel: its kRunRows rows as one
// run), gx blocks of 256
// threads by gy = k / kc column groups. adjoint = 1 computes rmatmat
// (A^T, or A^H for the complex types, whose pointers are to interleaved
// (re, im) pairs). Each entry point returns the CUDA error of its launch
// as an int (0: none; an instance that does not exist or a grid that
// misses a row is refused). The mixed entry points (dia_<half>_<block>)
// take half vals and X and Y in the block's type.
#define DIA_ENTRY(V, T, SUFFIX)                                              \
  extern "C" int dia_##SUFFIX(const V* vals, const long long* offs, int B,  \
                              const T* X, long long ldx, T* Y, int n, int k, \
                              int adjoint, int kernel, int kc, int vw,       \
                              int gx, int gy, void* stream) {                \
    return launch<T, V>(vals, offs, B, X, ldx, Y, n, k, adjoint, kernel, kc, \
                        vw, gx, gy, stream);                                 \
  }

DIA_ENTRY(float, float, f32)
DIA_ENTRY(double, double, f64)
DIA_ENTRY(float2, float2, c64)
DIA_ENTRY(double2, double2, c128)
DIA_ENTRY(__half, __half, f16)
DIA_ENTRY(__nv_bfloat16, __nv_bfloat16, bf16)
DIA_ENTRY(__half, float, f16_f32)
DIA_ENTRY(__nv_bfloat16, float, bf16_f32)
DIA_ENTRY(__half, double, f16_f64)
DIA_ENTRY(__nv_bfloat16, double, bf16_f64)
#undef DIA_ENTRY
