// The port's sparse product on plain coalesced loads, for measurement only
// (tools/torch_spmm_variants.py times it against the shipped kernel).
//
// It is primme_tpu_torch/csrc/windowed_ell.cu (included whole) with the
// shared-memory ring taken out: one block of kWarps warps per kWarps
// slices, each lane reading its row's cols/vals straight from device
// memory through the same consumer loop (accumulate), so both give the
// same sums in the same order, bit for bit. Entry points take the shipped
// ones' arguments; k must be 1, 2, 4 or 8 and X, Y aligned to 16 bytes.

#include "windowed_ell.cu"

namespace {

template <typename T, int KC, int V>
__global__ void __launch_bounds__(kWarps * 32)
plain_spmm(const long long* __restrict__ slice_ptr,
           const int* __restrict__ rowlen, const int* __restrict__ cols,
           const T* __restrict__ vals, const T* __restrict__ X,
           T* __restrict__ Y, int n, int k) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = i * kSlice + lane;
  if (row >= n) return;
  const long long e = slice_ptr[i] + lane;
  T acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = T(0);
  accumulate<T, KC, V>(cols + e, vals + e, rowlen[row], X, k, k, acc);
  store_row<T, KC, V>(Y + (long)row * k, k, acc);
}

template <typename T, int KC, int V>
int plain_launch(const long long* slice_ptr, const int* rowlen,
                 const int* cols, const T* vals, const T* X, T* Y, int n,
                 void* stream) {
  const int nslices = (n + kSlice - 1) / kSlice;
  plain_spmm<T, KC, V><<<(nslices + kWarps - 1) / kWarps, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      slice_ptr, rowlen, cols, vals, X, Y, n, KC);
  return static_cast<int>(cudaGetLastError());
}

// the shipped kernel's choice of V for a whole, aligned chunk of k columns
template <typename T>
int plain(const long long* slice_ptr, const int* rowlen, const int* cols,
          const T* vals, const T* X, T* Y, int n, int k, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  switch (k) {
    case 1: return plain_launch<T, 1, 1>(slice_ptr, rowlen, cols, vals, X, Y,
                                         n, stream);
    case 2: return plain_launch<T, 2, 2>(slice_ptr, rowlen, cols, vals, X, Y,
                                         n, stream);
    case 4: return plain_launch<T, 4, kVec>(slice_ptr, rowlen, cols, vals, X,
                                            Y, n, stream);
    case 8: return plain_launch<T, 8, kVec>(slice_ptr, rowlen, cols, vals, X,
                                            Y, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sell_plain_spmm_f32(const long long* slice_ptr,
                                   const int* rowlen, const int* cols,
                                   const float* vals, const float* X,
                                   float* Y, int n, int k, void* stream) {
  return plain<float>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}

extern "C" int sell_plain_spmm_f64(const long long* slice_ptr,
                                   const int* rowlen, const int* cols,
                                   const double* vals, const double* X,
                                   double* Y, int n, int k, void* stream) {
  return plain<double>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}
