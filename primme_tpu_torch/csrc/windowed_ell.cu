// Windowed-slot ELL SpMM, Y = A X, for Hopper (sm_90a), in f32 and f64.
//
// Replaces two TPU kernels of primme_tpu/ops/pallas_windowed.py:
//   matmat    (the pl.pallas_call at :228), f32: windowed_ell_spmm_f32;
//   matmat_ds (the pl.pallas_call at :363), f64: windowed_ell_spmm_f64.
// The packed arrays are the ones that pallas_windowed.pack builds (and
// primme_tpu_torch/ops/windowed_ell.py copies): nnz binned by diagonal
// offset into 256-wide bins and stored slot-ELL per 1024-row bucket,
//   scal [nrb + nrb*S] i32   window block of each bucket ++ per-slot bases
//   offs [nrb, S, 1024] i32  offset of the slot's column inside its window
//   vals [nrb, S, 1024] T    value (0 in padding slots), T = float or double
// and the column of row r (0..1023 inside bucket b), slot s is
//   c = scal[b]*WB + scal[nrb + b*S + s]*128 + 128*(r/128) + offs[b,s,r] - pad.
//
// What bounds it: one SpMM streams vals+offs for every slot entry
// (nrb*S*1024 of them, padding included): 8 bytes in f32, 12 in f64,
// since offs stays i32. It also gathers one X row segment per nonzero
// (4 or 8 bytes per column). The flops (2 per nonzero and column) are
// negligible, so it is bound by device-memory bytes in both types, and
// the f64 product should take about 1.3-1.6x the f32 one, not 2x.
//
// What this design does about that: the TPU kernels built eight shifted
// copies of X and a [8,128] lane-shuffle scan because a lane shuffle is
// the TPU's only gather, and matmat_ds carried f64 as f32 hi/lo streams
// with Dekker two-products and Knuth two-sums because Mosaic has no
// 64-bit vectors. Hopper gathers from any address and has native FP64,
// so none of that carries over: one template serves both types. One
// thread owns one output row; a warp reads 32 consecutive rows of a slot,
// so every vals/offs load is coalesced (128 bytes of offs, 128 or 256 of
// vals), and padding slots (v == 0) skip their gather. The gathered X
// rows of a bucket fall in its band window (at most 2*WB columns), which
// L2 (50 MB) serves; staging the window in shared memory with TMA, as the
// TPU kernel staged it in VMEM, is left for later work. Columns of X are
// processed in chunks of up to 8 held in registers, so any k >= 1 works;
// the sum over slots runs in slot order, with fma in the type T.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBucket = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
windowed_ell_spmm_kernel(const int* __restrict__ scal,
                         const int* __restrict__ offs,
                         const T* __restrict__ vals,
                         const T* __restrict__ X,
                         T* __restrict__ Y,
                         int nrb, int S, int n, int pad, int WB, int k,
                         int j0, int kc) {
  const int b = blockIdx.x;
  const int r = blockIdx.y * kThreads + threadIdx.x;   // row in bucket
  const long row = (long)b * kRowsPerBucket + r;
  // column = wbase + rel*128 + off; i32 is enough: |c| < n + 2*WB + pad
  const int wbase = scal[b] * WB + 128 * (r >> 7) - pad;
  const int* __restrict__ rel = scal + nrb + (long)b * S;
  const long slot0 = (long)b * S * kRowsPerBucket + r;

  T acc[KC];
#pragma unroll
  for (int jj = 0; jj < KC; ++jj) acc[jj] = T(0);

  for (int s = 0; s < S; ++s) {
    const long e = slot0 + (long)s * kRowsPerBucket;
    const T v = vals[e];
    if (v == T(0)) continue;               // padding slot
    const int c = wbase + rel[s] * 128 + offs[e];
    if (c < 0 || c >= n) continue;         // parked padding can point off A
    const T* __restrict__ xr = X + (long)c * k + j0;
#pragma unroll
    for (int jj = 0; jj < KC; ++jj)
      if (jj < kc) acc[jj] = fma_t(v, xr[jj], acc[jj]);
  }
  if (row < n) {
    T* __restrict__ yr = Y + row * k + j0;
#pragma unroll
    for (int jj = 0; jj < KC; ++jj)
      if (jj < kc) yr[jj] = acc[jj];
  }
}

template <typename T, int KC>
void launch(dim3 grid, cudaStream_t st, const int* scal, const int* offs,
            const T* vals, const T* X, T* Y, int nrb, int S, int n, int pad,
            int WB, int k, int j0, int kc) {
  windowed_ell_spmm_kernel<T, KC><<<grid, kThreads, 0, st>>>(
      scal, offs, vals, X, Y, nrb, S, n, pad, WB, k, j0, kc);
}

template <typename T>
int spmm(const int* scal, const int* offs, const T* vals, const T* X, T* Y,
         int nrb, int S, int n, int pad, int WB, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nrb, kRowsPerBucket / kThreads);
  for (int j0 = 0; j0 < k; j0 += 8) {
    const int kc = k - j0 < 8 ? k - j0 : 8;
    if (kc == 1)
      launch<T, 1>(grid, st, scal, offs, vals, X, Y, nrb, S, n, pad, WB, k,
                   j0, kc);
    else if (kc == 2)
      launch<T, 2>(grid, st, scal, offs, vals, X, Y, nrb, S, n, pad, WB, k,
                   j0, kc);
    else if (kc <= 4)
      launch<T, 4>(grid, st, scal, offs, vals, X, Y, nrb, S, n, pad, WB, k,
                   j0, kc);
    else
      launch<T, 8>(grid, st, scal, offs, vals, X, Y, nrb, S, n, pad, WB, k,
                   j0, kc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X and Y are row-major [n, k] in the type of vals; each entry point
// returns cudaGetLastError() as an int.
extern "C" int windowed_ell_spmm_f32(const int* scal, const int* offs,
                                     const float* vals, const float* X,
                                     float* Y, int nrb, int S, int n,
                                     int pad, int WB, int k, void* stream) {
  return spmm<float>(scal, offs, vals, X, Y, nrb, S, n, pad, WB, k, stream);
}

extern "C" int windowed_ell_spmm_f64(const int* scal, const int* offs,
                                     const double* vals, const double* X,
                                     double* Y, int nrb, int S, int n,
                                     int pad, int WB, int k, void* stream) {
  return spmm<double>(scal, offs, vals, X, Y, nrb, S, n, pad, WB, k, stream);
}
