// Thread shapes of the complex Jacobi kernel, for measurement only
// (tools/torch_kernel_variants.py times them against each other and
// against the shipped kernel).
//
// It is primme_tpu_torch/csrc/jacobi.cu (included whole) instantiated at
// other shapes: the columns of its row group a thread holds (group 0: one
// vector of VW columns, as the real kernel; group 1: up to 32 bytes of
// the group, one reciprocal for them all) and the rows it has in flight
// (1, 2 or 4). Every shape computes the same elements in the same way, so
// all agree bit for bit. The wrapper passes the grid for its shape.

#include "jacobi.cu"

namespace {

template <typename T, int KC, int VW, int COLS, bool kShifted>
Launch<T> variant_rows(int rows) {
  switch (rows) {
    case 1: return instance<T, KC, VW, COLS, 1, kShifted>();
    case 2: return instance<T, KC, VW, COLS, 2, kShifted>();
    case 4: return instance<T, KC, VW, COLS, 4, kShifted>();
    default: return {nullptr, 0};
  }
}

template <typename T, int KC, int VW, bool kShifted>
Launch<T> variant_shape(int group, int rows) {
  constexpr int kGroup = KC < int(32 / sizeof(T)) ? KC : int(32 / sizeof(T));
  return group ? variant_rows<T, KC, VW, kGroup, kShifted>(rows)
               : variant_rows<T, KC, VW, VW, kShifted>(rows);
}

template <typename T, int KC, bool kShifted>
Launch<T> variant_vw(int vw, int group, int rows) {
  if (vw == 1) return variant_shape<T, KC, 1, kShifted>(group, rows);
  if constexpr (fits<T, KC, 2>()) {
    if (vw == 2) return variant_shape<T, KC, 2, kShifted>(group, rows);
  }
  return {nullptr, 0};
}

template <typename T, bool kShifted>
Launch<T> variant(int kc, int vw, int group, int rows) {
  switch (kc) {
    case 1: return variant_vw<T, 1, kShifted>(vw, group, rows);
    case 2: return variant_vw<T, 2, kShifted>(vw, group, rows);
    case 4: return variant_vw<T, 4, kShifted>(vw, group, rows);
    case 8: return variant_vw<T, 8, kShifted>(vw, group, rows);
    default: return {nullptr, 0};
  }
}

template <typename T>
int run_variant(int shifted, const T* X, const T* d, const T* sigma, T* Y,
                int n, int k, long long ldx, typename Real<T>::type eps,
                int kc, int vw, int group, int rows, int blocks,
                void* stream) {
  const Launch<T> L = shifted ? variant<T, true>(kc, vw, group, rows)
                              : variant<T, false>(kc, vw, group, rows);
  return run<T>(L, X, d, sigma, Y, n, k, ldx, eps, kc, blocks, stream);
}

}  // namespace

extern "C" int jacobi_variant_c64(int shifted, const float2* X,
                                  const float2* d, const float2* sigma,
                                  float2* Y, int n, int k, long long ldx,
                                  float eps, int kc, int vw, int group,
                                  int rows, int blocks, void* stream) {
  return run_variant<float2>(shifted, X, d, sigma, Y, n, k, ldx, eps, kc, vw,
                             group, rows, blocks, stream);
}

extern "C" int jacobi_variant_c128(int shifted, const double2* X,
                                   const double2* d, const double2* sigma,
                                   double2* Y, int n, int k, long long ldx,
                                   double eps, int kc, int vw, int group,
                                   int rows, int blocks, void* stream) {
  return run_variant<double2>(shifted, X, d, sigma, Y, n, k, ldx, eps, kc,
                              vw, group, rows, blocks, stream);
}
