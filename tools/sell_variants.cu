// The sliced-ELL kernel's direct path with each way a lane can read its
// cols/vals, for measurement only (tools/torch_kernel_variants.py times
// them against the ring and each other).
//
// It is primme_tpu_torch/csrc/windowed_ell.cu (included whole) with the
// direct kernel instantiated at each loader: 0 plain, 1 streaming
// (ld.global.cs), 2 read-only (ld.global.nc), 3 L2 only (ld.global.cg).
// All run the same consumer loop in the same slot order, so all agree
// bit for bit. k must be 1, 2, 4 or 8, X and Y aligned to 16 bytes.

#include "windowed_ell.cu"

namespace {

struct Streaming {   // evict-first in L1 and L2 (ld.global.cs)
  template <typename E>
  static __device__ __forceinline__ E ld(const E* p) { return __ldcs(p); }
};
struct ReadOnly {    // the read-only path (ld.global.nc)
  template <typename E>
  static __device__ __forceinline__ E ld(const E* p) { return __ldg(p); }
};
struct L2Only {      // cached in L2, not in L1 (ld.global.cg)
  template <typename E>
  static __device__ __forceinline__ E ld(const E* p) { return __ldcg(p); }
};

template <typename T, int KC, int V>
int variant_launch(int loader, const long long* slice_ptr, const int* rowlen,
                   const int* cols, const T* vals, const T* X, T* Y, int n,
                   void* stream) {
  const int nslices = (n + kSlice - 1) / kSlice;
  const int grid = (nslices + kDirectWarps - 1) / kDirectWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (loader) {
    case 0:
      sliced_ell_direct<T, KC, V, Plain><<<grid, kDirectWarps * 32, 0, st>>>(
          slice_ptr, rowlen, cols, vals, X, Y, n, KC, KC);
      break;
    case 1:
      sliced_ell_direct<T, KC, V, Streaming>
          <<<grid, kDirectWarps * 32, 0, st>>>(slice_ptr, rowlen, cols, vals,
                                               X, Y, n, KC, KC);
      break;
    case 2:
      sliced_ell_direct<T, KC, V, ReadOnly>
          <<<grid, kDirectWarps * 32, 0, st>>>(slice_ptr, rowlen, cols, vals,
                                               X, Y, n, KC, KC);
      break;
    case 3:
      sliced_ell_direct<T, KC, V, L2Only><<<grid, kDirectWarps * 32, 0, st>>>(
          slice_ptr, rowlen, cols, vals, X, Y, n, KC, KC);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the shipped kernel's choice of V for a whole, aligned chunk of k columns
template <typename T>
int variant(int loader, const long long* slice_ptr, const int* rowlen,
            const int* cols, const T* vals, const T* X, T* Y, int n, int k,
            void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kV2 = kVec < 2 ? kVec : 2;
  switch (k) {
    case 1: return variant_launch<T, 1, 1>(loader, slice_ptr, rowlen, cols,
                                           vals, X, Y, n, stream);
    case 2: return variant_launch<T, 2, kV2>(loader, slice_ptr, rowlen, cols,
                                             vals, X, Y, n, stream);
    case 4: return variant_launch<T, 4, kVec>(loader, slice_ptr, rowlen, cols,
                                              vals, X, Y, n, stream);
    case 8: return variant_launch<T, 8, kVec>(loader, slice_ptr, rowlen, cols,
                                              vals, X, Y, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define VARIANT_ENTRY(T, SUFFIX)                                              \
  extern "C" int sell_variant_##SUFFIX(                                       \
      int loader, const long long* slice_ptr, const int* rowlen,              \
      const int* cols, const T* vals, const T* X, T* Y, int n, int k,         \
      void* stream) {                                                         \
    return variant<T>(loader, slice_ptr, rowlen, cols, vals, X, Y, n, k,      \
                      stream);                                                \
  }

VARIANT_ENTRY(float, f32)
VARIANT_ENTRY(double, f64)
VARIANT_ENTRY(float2, c64)
VARIANT_ENTRY(double2, c128)
