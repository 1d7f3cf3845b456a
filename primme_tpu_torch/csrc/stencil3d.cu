// 7-point 3-D Laplacian product Y = scale * (6 X - sum of the six neighbours)
// on an nx x ny x nz grid with Dirichlet edges, for Hopper (sm_90a), in f32
// and f64.
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
// and L2. The wrapper refuses a grid whose j tiles or (plane, column group)
// pairs pass CUDA's 65535 along y or z: a block that steps through several
// measured 8-25% slower at every shape, so no grid is folded.
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

#include <cuda_runtime.h>

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

// Block (x, y, z) computes the points of l tile x and j tile y (tj =
// blockDim.y rows) in (plane, column group) pair z of the nx * (k / KC),
// group fastest; a block past the grid's edge computes nothing. A thread's
// columns and its six neighbours' come straight from L1/L2, VW elements a
// load, all seven in flight at once, and are summed in the reference's
// order.
template <typename T, int KC, int VW>
__global__ void __launch_bounds__(kTileL* kMaxTJ)
    stencil3d_kernel(const T* __restrict__ X, T* __restrict__ Y, int nx,
                     int ny, int nz, int k, long long ldx, T scale) {
  constexpr int kParts = parts<T, KC>();
  constexpr int kPC = KC / kParts;  // columns of one thread
  const int l = blockIdx.x * (kTileL / kParts) + threadIdx.x / kParts;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  int i = blockIdx.z, c0 = (threadIdx.x % kParts) * kPC;
  if (k != KC) {  // column groups: z = plane * groups + group
    const int groups = k / KC;
    i = blockIdx.z / groups;
    c0 += (blockIdx.z - i * groups) * KC;
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

template <typename T>
using Kernel = void (*)(const T*, T*, int, int, int, int, long long, T);

template <typename T, int KC>
Kernel<T> pick_vw(int vw) {
  if (vw == 1) return stencil3d_kernel<T, KC, 1>;
  if constexpr (KC >= 2) {
    if (vw == 2) return stencil3d_kernel<T, KC, 2>;
  }
  if constexpr (KC >= 4 && sizeof(T) == 4) {
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
           T scale, int kc, int vw, int tj, int gx, int gy, int gz,
           void* stream) {
  const Kernel<T> fn = pick<T>(kc, vw);
  // the grid is the wrapper's plan; here only what CUDA and the kernel's
  // instances take (blocks past the grid's edge compute nothing)
  if (fn == nullptr || k % kc != 0 || tj < 1 || tj > kMaxTJ || gx < 1 ||
      gy < 1 || gy > kMaxGridYZ || gz < 1 || gz > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fn<<<dim3(gx, gy, gz), dim3(kTileL, tj), 0,
       static_cast<cudaStream_t>(stream)>>>(X, Y, nx, ny, nz, k, ldx, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/stencil3d.py::plan) plans the launch:
// kc columns a point, X loaded vw elements at a time, blocks of 32 x tj
// threads on a gx x gy x gz grid that covers every point.
// Each entry point returns the CUDA error of its launch as an int (0:
// none).
extern "C" int stencil3d_f32(const float* X, float* Y, int nx, int ny, int nz,
                             int k, long long ldx, float scale, int kc, int vw,
                             int tj, int gx, int gy, int gz, void* stream) {
  return launch<float>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw, tj, gx, gy,
                       gz, stream);
}

extern "C" int stencil3d_f64(const double* X, double* Y, int nx, int ny,
                             int nz, int k, long long ldx, double scale,
                             int kc, int vw, int tj, int gx, int gy, int gz,
                             void* stream) {
  return launch<double>(X, Y, nx, ny, nz, k, ldx, scale, kc, vw, tj, gx, gy,
                        gz, stream);
}
