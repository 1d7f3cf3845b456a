// 7-point 3-D Laplacian product Y = scale * (6 X - sum of the six neighbours)
// on an nx x ny x nz grid with Dirichlet edges, for Hopper (sm_90a), in f32,
// f64, f16 and bf16.
//
// Replaces the XLA-fused product of primme_tpu/operators.py::
// Stencil3DOperator.matmat (:379-397; the JAX package has no Pallas kernel
// for it): every outer matvec, QMR step, probe filter step and power
// iteration of bench.py's headline solve runs through it.
//
// Layout: X is [n, k] with n = nx*ny*nz rows in the grid order of the
// reference, row (i*ny + j)*nz + l, columns innermost; its rows may lie
// ldx >= k elements apart (a column slice of a wider block needs no copy),
// its columns are adjacent. Y is a new contiguous [n, k].
//
// What bounds it: each element of X is read once and each of Y written
// once, 2 n k sizeof(T) bytes, with 7 flops per element: bound by device
// memory. At 64^3 and k=2 in f32 that is 4.19 MB, 1.25 us at 3.35 TB/s,
// below the time of a launch (and small enough to stay in the 50 MB L2);
// at 256^3 and k=2 it is 268 MB, 80.1 us.
//
// What the design does about that: one thread per grid point, holding
// the point's kc adjacent columns (kc = 8, 4, 2 or 1, the largest that
// divides k; a k with more columns runs k/kc column groups as separate
// planes of blocks), X loaded vw elements at a time (16, 8 or 4 bytes, as
// wide as kc, ldx and X's address allow; 1 element, the scalar path, for a
// slice of the basis at an odd column offset), Y, contiguous, written in
// the same vectors. A point wider than 16 bytes is shared by threads, 16
// bytes each, so that a warp's loads stay adjacent. A block is a tile of
// one plane, 32 (fewer where threads share a point) x tj points, on a 3-D
// grid (l tile, j tile, plane x column group): a thread finds its point
// without a division. A thread's seven loads (the point and its six
// neighbours; one outside the grid reads the point itself and counts as 0,
// so no load waits on a branch) are all in flight at once, served by L1
// and L2. A grid whose j tiles or (plane, column group) pairs pass CUDA's
// 65535 along y or z runs as several launches, each over at most 65535 of
// them from a j tile and a pair offset (a block that steps through several
// measured 8-25% slower at every shape, so no grid is folded into one
// launch); every other grid is one launch at offsets 0.
// (Marching planes through shared memory measured slower at every shape
// with whole-point loads: its prologue and barriers cost a short march more
// than the L1/L2 loads it saves. It won only on slices at an odd column
// offset, which the solve does not pass; see PERF.md.)
// The arithmetic keeps the reference's order, one IEEE rounding per
// operation with no contraction into an fma:
//   out = 6 g; out = out - x(i+1) - x(i-1); ... axes 0, 1, 2 ...;
//   y = scale * out
// so the kernel equals its plain PyTorch version bit for bit; a neighbour
// outside the grid is 0. Addresses are 64-bit.
//
// The 16-bit entry points (stencil3d_f16, stencil3d_bf16) serve a half
// operator (primme_tpu/operators.py::Stencil3DOperator with a half dtype:
// the block cast to it, every operation in it). Each operation is packed:
// one lane of a mul.rn / sub.rn f16x2 or bf16x2 instruction (half2.cuh),
// the correctly rounded half operation that torch's half arithmetic and
// the JAX package's op-by-op half arithmetic give, in the same order, so
// the kernel equals its plain version bit for bit. (Each one taken in
// f32 on the widened operands and narrowed would cost eight narrowings a
// point and column on the slow conversion pipe.) A pair is
// two adjacent columns of a point, or two adjacent points of one column.
// Where X's rows are the block's own (ldx = kc <= 4) and nz is even, a
// thread takes two adjacent points along l, whose 2 kc halves are one
// aligned run, so that each of the seven taps is one load of 4, 8 or 16
// bytes for two points (the pair of the l neighbours, one point over, is
// put together from the run and the points before and after it: words,
// or at kc = 1 halves with a byte permute). Otherwise a thread takes one
// point: kc >= 2 columns in vectors of up to eight halves, or one column
// (a slice of the basis) on both lanes. The bytes halve, so the
// bound does: 64^3 at k=2 is 2.10 MB, 0.63 us; 256^3 at k=2 134 MB,
// 40.1 us.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "half2.cuh"

namespace {

constexpr int kTileL = 32;           // threads of a block along l: one warp
constexpr int kMaxTJ = 8;            // tile rows along j: blocks of <= 256
constexpr int kMaxGridYZ = 65535;    // CUDA's limit on gridDim.y and .z

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
// W elements of T as one load: the vector type of W * sizeof(T) bytes
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

// Threads that share a point: one per 16 bytes of it.
template <typename T, int KC>
__host__ __device__ constexpr int parts() {
  return KC * sizeof(T) > 16 ? KC * sizeof(T) / 16 : 1;
}

// Block (x, y, z) computes the points of l tile x and j tile y0 + y (tj =
// blockDim.y rows) in (plane, column group) pair z0 + z of the nx * (k /
// KC), group fastest; a block past the grid's edge computes nothing. A thread's
// columns and its six neighbours' come straight from L1/L2, VW elements a
// load, all seven in flight at once, and are summed in the reference's
// order.
template <typename T, int KC, int VW>
__global__ void __launch_bounds__(kTileL* kMaxTJ)
    stencil3d_kernel(const T* __restrict__ X, T* __restrict__ Y, int nx,
                     int ny, int nz, int k, long long ldx, T scale, int y0,
                     int z0) {
  constexpr int kParts = parts<T, KC>();
  constexpr int kPC = KC / kParts;  // columns of one thread
  const int l = blockIdx.x * (kTileL / kParts) + threadIdx.x / kParts;
  const int j = (blockIdx.y + y0) * blockDim.y + threadIdx.y;
  const int z = blockIdx.z + z0;
  int i = z, c0 = (threadIdx.x % kParts) * kPC;
  if (k != KC) {  // column groups: z = plane * groups + group
    const int groups = k / KC;
    i = z / groups;
    c0 += (z - i * groups) * KC;
  }
  if (l >= nz || j >= ny || i >= nx) return;
  const long long row = (static_cast<long long>(i) * ny + j) * nz + l;
  const T* x = X + row * ldx + c0;
  const long long s1 = static_cast<long long>(nz) * ldx;
  const long long s0 = static_cast<long long>(ny) * s1;
  // the six neighbours in the order of the sum; one outside the grid
  // reads the point itself (no branch, so that all seven loads are in
  // flight at once) and counts as 0
  const bool in[6] = {i + 1 < nx, i > 0, j + 1 < ny, j > 0, l + 1 < nz,
                      l > 0};
  const long long d[6] = {s0, -s0, s1, -s1, ldx, -ldx};
#pragma unroll
  for (int c = 0; c < kPC; c += VW) {
    T g[VW], a[6][VW], out[VW];
    ldg_vec<T, VW>(x + c, g);
#pragma unroll
    for (int m = 0; m < 6; ++m) ldg_vec<T, VW>(x + (in[m] ? d[m] : 0) + c, a[m]);
#pragma unroll
    for (int e = 0; e < VW; ++e) out[e] = mul_rn(T(6), g[e]);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        out[e] = sub_rn(out[e], in[m] ? a[m][e] : T(0));
      }
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) out[e] = mul_rn(scale, out[e]);
    st_vec<T, VW>(Y + row * k + c0 + c, out);
  }
}

// Half types. Block (x, y, z) as above; a thread takes the two points l
// and l + 1 where they are one aligned run of 2 KC halves (VW = 2 KC, KC
// <= 4: X's rows KC apart, nz even, X's address aligned to 4 KC bytes), so
// that each tap is one load of 4, 8 or 16 bytes; else one point, of KC >=
// 2 columns (VW halves a load) or of one column (its value on both lanes).
// It sums the pairs packed in the reference's order. scale2 is the half
// scale on both lanes.
template <typename H, int KC, int VW>
__global__ void __launch_bounds__(kTileL* kMaxTJ)
    stencil3d_half_kernel(const H* __restrict__ X, H* __restrict__ Y, int nx,
                          int ny, int nz, int k, long long ldx,
                          unsigned scale2, int y0, int z0) {
  using P = half2ops::Packed<H>;
  using half2ops::pack;
  constexpr int kPts = VW > KC ? 2 : 1;          // points along l
  constexpr int kW = KC * kPts / 2 > 0 ? KC * kPts / 2 : 1;  // words a tap
  // 6 on both lanes
  constexpr unsigned kSix =
      std::is_same<H, __half>::value ? 0x46004600u : 0x40c040c0u;
  const int l = (blockIdx.x * kTileL + threadIdx.x) * kPts;
  const int j = (blockIdx.y + y0) * blockDim.y + threadIdx.y;
  const int z = blockIdx.z + z0;
  int i = z, c0 = 0;
  if (k != KC) {  // column groups: z = plane * groups + group
    const int groups = k / KC;
    i = z / groups;
    c0 = (z - i * groups) * KC;
  }
  if (l >= nz || j >= ny || i >= nx) return;
  const long long row = (static_cast<long long>(i) * ny + j) * nz + l;
  const unsigned short* x =
      reinterpret_cast<const unsigned short*>(X) + row * ldx + c0;
  const long long s1 = static_cast<long long>(nz) * ldx;
  const long long s0 = static_cast<long long>(ny) * s1;
  // taps in the order of the sum: the point, then i+1, i-1, j+1, j-1, l+1,
  // l-1; a tap outside the grid reads the point itself and counts as 0
  unsigned g[kW], a[6][kW];
  const bool in_ij[4] = {i + 1 < nx, i > 0, j + 1 < ny, j > 0};
  const long long d_ij[4] = {s0, -s0, s1, -s1};
  if constexpr (kPts == 2) {
    // two points, X's rows KC apart (ldx = KC), nz even, l even: the pair
    // of points is 2 KC adjacent halves, aligned to 4 KC bytes, and so is
    // every tap's pair; the l neighbours' pairs are the pair one point
    // over, from the point before it and the one after it
    constexpr int kEdge = KC == 1 ? 2 : KC;   // halves loaded past an end
    const bool next_in = l + 2 < nz, prev_in = l > 0;
    unsigned t[4][kW], next[kEdge / 2], prev[kEdge / 2];
    half2ops::ld_aligned<VW>(x, g);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      half2ops::ld_aligned<VW>(x + (in_ij[m] ? d_ij[m] : 0), t[m]);
    half2ops::ld_aligned<kEdge>(x + (next_in ? VW : 0), next);
    half2ops::ld_aligned<kEdge>(x - (prev_in ? kEdge : 0), prev);
#pragma unroll
    for (int q = 0; q < kW; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m][q] = in_ij[m] ? t[m][q] : 0u;
#pragma unroll
    for (int q = 0; q < kEdge / 2; ++q) {
      next[q] = next_in ? next[q] : 0u;
      prev[q] = prev_in ? prev[q] : 0u;
    }
    if constexpr (KC == 1) {
      // (x[l+1], x[l+2]) and (x[l-1], x[l])
      a[4][0] = half2ops::shift_pair(g[0], next[0]);
      a[5][0] = half2ops::shift_pair(prev[0], g[0]);
    } else {
      constexpr int kP = KC / 2;                // words of a point
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        a[4][q] = q + kP < kW ? g[q + kP] : next[q + kP - kW];
        a[5][q] = q >= kP ? g[q - kP] : prev[q];
      }
    }
  } else if constexpr (KC >= 2) {
    const bool in_l[2] = {l + 1 < nz, l > 0};
    half2ops::ld_row<KC, VW>(x, g);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      half2ops::ld_row<KC, VW>(x + (in_ij[m] ? d_ij[m] : 0), a[m]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
      half2ops::ld_row<KC, VW>(x + (in_l[m] ? (m ? -ldx : ldx) : 0),
                               a[4 + m]);
#pragma unroll
    for (int q = 0; q < kW; ++q) {
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m][q] = in_ij[m] ? a[m][q] : 0u;
#pragma unroll
      for (int m = 0; m < 2; ++m) a[4 + m][q] = in_l[m] ? a[4 + m][q] : 0u;
    }
  } else {
    // one point (a slice, or an odd nz), its value on both lanes
    const bool in_l[2] = {l + 1 < nz, l > 0};
    const unsigned short g0 = __ldg(x);
    g[0] = pack(g0, g0);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned short v = __ldg(x + (in_ij[m] ? d_ij[m] : 0));
      a[m][0] = in_ij[m] ? pack(v, v) : 0u;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned short v =
          __ldg(x + (in_l[m] ? (m ? -ldx : ldx) : 0));
      a[4 + m][0] = in_l[m] ? pack(v, v) : 0u;
    }
  }
  unsigned out[kW];
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    out[q] = P::mul(kSix, g[q]);
#pragma unroll
    for (int m = 0; m < 6; ++m) out[q] = P::sub(out[q], a[m][q]);
    out[q] = P::mul(scale2, out[q]);
  }
  unsigned short* y = reinterpret_cast<unsigned short*>(Y) + row * k + c0;
  if constexpr (kPts == 2) {
    half2ops::st_halves<VW>(y, out);            // k = KC, row even
  } else if constexpr (KC >= 2) {
    half2ops::st_halves<KC>(y, out);
  } else {
    y[0] = static_cast<unsigned short>(out[0]);
  }
}

template <typename H>
using HalfKernel = void (*)(const H*, H*, int, int, int, int, long long,
                            unsigned, int, int);

// VW <= KC: one point a thread, VW halves a load; VW = 2 KC (KC <= 4):
// two points a thread, one load a tap
template <typename H, int KC>
HalfKernel<H> pick_half_vw(int vw) {
  if (vw == 1) return stencil3d_half_kernel<H, KC, 1>;
  if (vw == 2) return stencil3d_half_kernel<H, KC, 2>;
  if constexpr (KC >= 2) {
    if (vw == 4) return stencil3d_half_kernel<H, KC, 4>;
  }
  if constexpr (KC >= 4) {
    if (vw == 8) return stencil3d_half_kernel<H, KC, 8>;
  }
  return nullptr;
}

template <typename H>
HalfKernel<H> pick_half(int kc, int vw) {
  switch (kc) {
    case 1: return pick_half_vw<H, 1>(vw);
    case 2: return pick_half_vw<H, 2>(vw);
    case 4: return pick_half_vw<H, 4>(vw);
    case 8: return pick_half_vw<H, 8>(vw);
    default: return nullptr;
  }
}

// the half kernel's launch; scale is the f32 value of a half (exact)
template <typename H>
int launch_half(const H* X, H* Y, int nx, int ny, int nz, int k,
                long long ldx, float scale, int kc, int vw, int tj, int gx,
                int gy, int gz, int y0, int z0, void* stream) {
  const HalfKernel<H> fn = pick_half<H>(kc, vw);
  const size_t xa = reinterpret_cast<size_t>(X);
  // vw = 2 kc: two points a thread, X's rows kc apart
  const bool paired = vw == 2 * kc;
  if (fn == nullptr || k % kc != 0 || tj < 1 || tj > kMaxTJ || gx < 1 ||
      gy < 1 || gy > kMaxGridYZ || gz < 1 || gz > kMaxGridYZ || y0 < 0 ||
      z0 < 0 || xa % (2 * static_cast<size_t>(vw)) != 0 ||
      (paired ? ldx != kc || nz % 2 != 0 : ldx % vw != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  H half_scale;
  if constexpr (std::is_same<H, __half>::value) {
    half_scale = __float2half_rn(scale);
  } else {
    half_scale = __float2bfloat16_rn(scale);
  }
  unsigned short h;
  std::memcpy(&h, &half_scale, sizeof(h));
  fn<<<dim3(gx, gy, gz), dim3(kTileL, tj), 0,
       static_cast<cudaStream_t>(stream)>>>(X, Y, nx, ny, nz, k, ldx,
                                            half2ops::pack(h, h), y0, z0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using Kernel = void (*)(const T*, T*, int, int, int, int, long long, T, int,
                        int);

template <typename T, int KC>
Kernel<T> pick_vw(int vw) {
  if (vw == 1) return stencil3d_kernel<T, KC, 1>;
  if constexpr (KC >= 2) {
    if (vw == 2) return stencil3d_kernel<T, KC, 2>;
  }
  if constexpr (KC >= 4 && sizeof(T) <= 4) {
    if (vw == 4) return stencil3d_kernel<T, KC, 4>;
  }
  return nullptr;
}

// The instance for kc columns a point loaded vw at a time; nullptr for a
// pair the wrapper never plans.
template <typename T>
Kernel<T> pick(int kc, int vw) {
  switch (kc) {
    case 1: return pick_vw<T, 1>(vw);
    case 2: return pick_vw<T, 2>(vw);
    case 4: return pick_vw<T, 4>(vw);
    case 8: return pick_vw<T, 8>(vw);
    default: return nullptr;
  }
}

template <typename T>
int launch(const T* X, T* Y, int nx, int ny, int nz, int k, long long ldx,
           T scale, int kc, int vw, int tj, int gx, int gy, int gz, int y0,
           int z0, void* stream) {
  const Kernel<T> fn = pick<T>(kc, vw);
  // the grid is the wrapper's plan; here only what CUDA and the kernel's
  // instances take (blocks past the grid's edge compute nothing)
  if (fn == nullptr || k % kc != 0 || tj < 1 || tj > kMaxTJ || gx < 1 ||
      gy < 1 || gy > kMaxGridYZ || gz < 1 || gz > kMaxGridYZ || y0 < 0 ||
      z0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fn<<<dim3(gx, gy, gz), dim3(kTileL, tj), 0,
       static_cast<cudaStream_t>(stream)>>>(X, Y, nx, ny, nz, k, ldx, scale,
                                            y0, z0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/stencil3d.py::plan) plans the launch:
// kc columns a point, X loaded vw elements at a time, blocks of 32 x tj
// threads on gx x gy x gz grids, from j tile y0 and (plane, column group)
// pair z0, that together cover every point.
// Each entry point returns the CUDA error of its launch as an int (0:
// none).
extern "C" int stencil3d_f32(const float* X, float* Y, int nx, int ny, int nz,
                             int k, long long ldx, float scale, int kc, int vw,
                             int tj, int gx, int gy, int gz, int y0, int z0,
                             void* stream) {
  return launch<float>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw, tj, gx, gy,
                       gz, y0, z0, stream);
}

extern "C" int stencil3d_f64(const double* X, double* Y, int nx, int ny,
                             int nz, int k, long long ldx, double scale,
                             int kc, int vw, int tj, int gx, int gy, int gz,
                             int y0, int z0, void* stream) {
  return launch<double>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw, tj, gx, gy,
                        gz, y0, z0, stream);
}

// The 16-bit entry points take scale as the f32 value of the half it
// rounds to (the wrapper rounds it), so the conversion here is exact. At
// kc = 1 a thread takes two points along l: gx tiles of 64 points.
extern "C" int stencil3d_f16(const __half* X, __half* Y, int nx, int ny,
                             int nz, int k, long long ldx, float scale,
                             int kc, int vw, int tj, int gx, int gy, int gz,
                             int y0, int z0, void* stream) {
  return launch_half<__half>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw, tj, gx,
                             gy, gz, y0, z0, stream);
}

extern "C" int stencil3d_bf16(const __nv_bfloat16* X, __nv_bfloat16* Y,
                              int nx, int ny, int nz, int k, long long ldx,
                              float scale, int kc, int vw, int tj, int gx,
                              int gy, int gz, int y0, int z0, void* stream) {
  return launch_half<__nv_bfloat16>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw,
                                    tj, gx, gy, gz, y0, z0, stream);
}
