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
// below the time of a launch.
//
// What the design does about that: one thread per output element (row,
// column), columns innermost, so that a warp reads and writes neighbouring
// addresses. The grid is (line chunks, ny, nx): a block covers part of one
// grid line (i, j) of nz*k elements, so a thread finds its position with
// one 32-bit division by k and no division by the grid sizes. The six
// neighbours lie at +-ldx (axis 2), +-nz*ldx (axis 1) and +-ny*nz*ldx
// (axis 0); neighbouring lines and planes of X are read by neighbouring
// blocks, so L1 and L2 serve all but the first read of each element.
// Addresses are 64-bit. The arithmetic keeps the reference's order, one
// IEEE rounding per operation with no contraction into an fma:
//   out = 6 g; out = out - x(i+1) - x(i-1); ... axes 0, 1, 2 ...;
//   y = scale * out
// so the kernel equals its plain PyTorch version bit for bit; a neighbour
// outside the grid is 0.

#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void stencil3d_kernel(const T* __restrict__ X, T* __restrict__ Y,
                                 int nx, int ny, int nz, int k, long long ldx,
                                 T scale) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // (l, c) in the line
  if (r >= nz * k) return;
  const int j = blockIdx.y, i = blockIdx.z;
  const int l = r / k, c = r - l * k;
  const long long row = (static_cast<long long>(i) * ny + j) * nz + l;
  const T* x = X + row * ldx + c;
  const long long s2 = ldx;
  const long long s1 = static_cast<long long>(nz) * ldx;
  const long long s0 = static_cast<long long>(ny) * s1;
  const T zero = T(0);
  T out = mul_rn(T(6), __ldg(x));
  out = sub_rn(out, i + 1 < nx ? __ldg(x + s0) : zero);
  out = sub_rn(out, i > 0 ? __ldg(x - s0) : zero);
  out = sub_rn(out, j + 1 < ny ? __ldg(x + s1) : zero);
  out = sub_rn(out, j > 0 ? __ldg(x - s1) : zero);
  out = sub_rn(out, l + 1 < nz ? __ldg(x + s2) : zero);
  out = sub_rn(out, l > 0 ? __ldg(x - s2) : zero);
  Y[row * k + c] = mul_rn(scale, out);
}

template <typename T>
int launch(const T* X, T* Y, int nx, int ny, int nz, int k, long long ldx,
           T scale, void* stream) {
  const int line = nz * k;                  // elements of one grid line
  int threads = (line + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((line + threads - 1) / threads, ny, nx);
  stencil3d_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, Y, nx, ny, nz, k, ldx, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (primme_tpu_torch/ops/stencil3d.py) checks the shapes: nx, ny
// <= 65535 (grid dimensions), nz*k < 2**31, ldx >= k. Each entry point
// returns the CUDA error of its launch as an int (0: none).
extern "C" int stencil3d_f32(const float* X, float* Y, int nx, int ny, int nz,
                             int k, long long ldx, float scale, void* stream) {
  return launch<float>(X, Y, nx, ny, nz, k, ldx, scale, stream);
}

extern "C" int stencil3d_f64(const double* X, double* Y, int nx, int ny,
                             int nz, int k, long long ldx, double scale,
                             void* stream) {
  return launch<double>(X, Y, nx, ny, nz, k, ldx, scale, stream);
}
