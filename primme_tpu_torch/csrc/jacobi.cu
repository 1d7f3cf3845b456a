// Shift-aware Jacobi preconditioner apply for Hopper (sm_90a), in f32 and
// f64:
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
// 3.35 TB/s, below the time of a launch.
//
// What the design does about that: one thread per element, columns
// innermost, so that a warp reads and writes neighbouring addresses (d is
// read k times from L1, sigma stays in L1). The two forms keep the
// reference's rounding, which differs between them: the shifted one is one
// IEEE division (__fdiv_rn / __ddiv_rn, whatever the division flags), the
// unshifted one a reciprocal and then a product. Both compare |den| < eps
// as the reference does, so a NaN den propagates. Indices are 64-bit.

#include <cuda_runtime.h>

namespace {

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

template <typename T, bool kShifted>
__global__ void jacobi_kernel(const T* __restrict__ X,
                              const T* __restrict__ d,
                              const T* __restrict__ sigma, T* __restrict__ Y,
                              long long total, long long k, long long ldx,
                              T eps) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long row = e / k, c = e - row * k;
  const T x = __ldg(X + row * ldx + c);
  if (kShifted) {
    Y[e] = div_rn(x, guard(sub_rn(__ldg(d + row), __ldg(sigma + c)), eps));
  } else {
    Y[e] = mul_rn(div_rn(T(1), guard(__ldg(d + row), eps)), x);
  }
}

template <typename T, bool kShifted>
int launch(const T* X, const T* d, const T* sigma, T* Y, long long n,
           long long k, long long ldx, T eps, void* stream) {
  const long long total = n * k;
  constexpr int kThreads = 256;
  const long long blocks = (total + kThreads - 1) / kThreads;
  jacobi_kernel<T, kShifted>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          X, d, sigma, Y, total, k, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns the CUDA error of its launch as an int (0: none).
// The unshifted ones take no sigma.
extern "C" int jacobi_shifted_f32(const float* X, const float* d,
                                  const float* sigma, float* Y, long long n,
                                  long long k, long long ldx, float eps,
                                  void* stream) {
  return launch<float, true>(X, d, sigma, Y, n, k, ldx, eps, stream);
}

extern "C" int jacobi_shifted_f64(const double* X, const double* d,
                                  const double* sigma, double* Y, long long n,
                                  long long k, long long ldx, double eps,
                                  void* stream) {
  return launch<double, true>(X, d, sigma, Y, n, k, ldx, eps, stream);
}

extern "C" int jacobi_f32(const float* X, const float* d, float* Y,
                          long long n, long long k, long long ldx, float eps,
                          void* stream) {
  return launch<float, false>(X, d, nullptr, Y, n, k, ldx, eps, stream);
}

extern "C" int jacobi_f64(const double* X, const double* d, double* Y,
                          long long n, long long k, long long ldx, double eps,
                          void* stream) {
  return launch<double, false>(X, d, nullptr, Y, n, k, ldx, eps, stream);
}
