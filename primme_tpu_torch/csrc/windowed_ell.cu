// Sparse product Y = A X for Hopper (sm_90a), in f32, f64, complex64 and
// complex128, on the warp-sliced ELL layout that
// primme_tpu_torch/ops/windowed_ell.py::compact derives from the
// windowed-slot ELL packing (and from_csr builds from CSR).
//
// Replaces two TPU kernels of primme_tpu/ops/pallas_windowed.py:
//   matmat    (the pl.pallas_call at :228), f32: windowed_ell_spmm_f32;
//   matmat_ds (the pl.pallas_call at :363), f64: windowed_ell_spmm_f64;
// and the XLA gather of primme_tpu/operators.py::ELLOperator.matmat/
// rmatmat (:198-207) for complex values, which the JAX package computes
// outside any Pallas kernel: windowed_ell_spmm_c64 and _c128. A complex
// value is its (re, im) pair side by side (float2 or double2, torch's
// complex64 and complex128); the adjoint's layout holds A^H's values,
// conjugated when it is built, so no entry point conjugates.
// The layout keeps the packed (RCM) row order and holds no padding slot:
//   slice_ptr [ceil(n/32)+1] i64  first entry of each 32-row slice
//   rowlen    [n] i32             entries of each row
//   cols      [E] i32             absolute column of each entry
//   vals      [E] T               value: float, double, float2, double2
// Entry j of row 32i+l lies at slice_ptr[i] + 32j + l (slot-major inside a
// slice); a row's entries are its packed non-zero slots in slot order.
// The same layout serves an m x ncols matrix built from CSR (from_csr): n
// is its row count m, which bounds the rows of Y only, and X is [ncols, k]
// with every column index below ncols; offsets into X and Y are 64-bit.
//
// What bounds it: one product needs each non-zero's value and column once
// (nnz * (sizeof T + 4) bytes), X once and Y once (2 n k sizeof T); at 64^3
// and k=2 that is 59.1 MB in f32 and 90.7 MB in f64, 17.6 and 27.1 us at
// 3.35 TB/s. The layout adds the rows shorter than their slice's longest
// (E/nnz = 1.016 there) and rowlen. Two flops per 8-12 bytes: bound by
// device-memory bytes, far from any tensor-core use.
//
// What the design does about that: one thread sums one row and a warp owns
// a slice, so the cols/vals of one slot are one 128 or 256 byte line per
// warp. Persistent blocks (one per SM) walk groups of kWarps consecutive
// slices in order; one producer thread streams each group's cols/vals into
// a kStages-deep shared-memory ring with 1-D bulk async copies (evict_first
// in L2, since each byte is read once, so that X stays resident), kChunk
// slots per stage, completing on an mbarrier, while the kWarps consumer
// warps sum the stage before. A lane stops at its rowlen (no v == 0 test
// in the chain, no 0*x term), gathers X with one vector load per entry
// where k and alignment allow, and sums in slot order with fma in T, the
// order of the packed layout's plain version, so the result does not
// depend on the layout (a complex term as four fmas: re += vr xr, re +=
// -vi xi, im += vr xi, im += vi xr). Columns of X go in chunks of up to 8
// held in registers, one launch per chunk, so any k >= 1 works. A
// complex128 entry takes 20 bytes of the ring, so its stages hold half
// as many slots (kChunk 8) and the ring stays under 227 KB.
//
// What was dropped from the TPU kernels: their eight shifted copies of X
// and [8,128] lane-shuffle scan existed because a lane shuffle is the
// TPU's only gather, and matmat_ds carried f64 as f32 hi/lo streams with
// Dekker/Knuth compensation because Mosaic has no 64-bit vectors. Hopper
// gathers from any address and has native FP64. Their staging of each
// bucket's band window of X in VMEM does not carry over either: the window
// (2*WB = 49,152 rows of X, 393 KB at k=2 in f32) exceeds the 227 KB of
// shared memory a block may use, and X (2-4 MB at k=2) stays in the 50 MB
// L2; the bytes that matter are the matrix's, and the padding slots that
// were two thirds of them are gone from the layout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;              // rows per slice: lanes of a warp
constexpr int kWarps = 8;               // consumer warps: slices per group
// slots of a slice per stage: 16, 8 for the 16-byte complex128 values
template <typename T>
constexpr int kChunkOf = sizeof(T) > 8 ? 8 : 16;
constexpr int kStages = 4;              // depth of the ring
constexpr int kMaxKC = 8;               // columns of X per launch
constexpr int kMaxDevices = 64;         // occupancy cached per device below
static_assert(kWarps <= kSlice, "a group's widths are reduced in one warp");

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
// a complex c + a b: four fmas, the real part's two first
__device__ __forceinline__ float2 fma_t(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 fma_t(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
template <> __device__ __forceinline__ double2 zero<double2>() {
  return make_double2(0.0, 0.0);
}

// V > 1 consecutive elements of type T as one load or store
template <typename T, int V> struct Io;
template <> struct Io<float, 2> {
  static __device__ __forceinline__ void ld(const float* p, float* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void st(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Io<float, 4> {
  static __device__ __forceinline__ void ld(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
// two complex64 columns in 16 bytes
template <> struct Io<float2, 2> {
  static __device__ __forceinline__ void ld(const float2* p, float2* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = make_float2(v.x, v.y); o[1] = make_float2(v.z, v.w);
  }
  static __device__ __forceinline__ void st(float2* p, const float2* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x,
                                                v[1].y);
  }
};
template <> struct Io<double, 2> {
  static __device__ __forceinline__ void ld(const double* p, double* o) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void st(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// KC columns of one X row (kc of them real when V == 1; V > 1 means
// kc == KC and aligned rows).
template <typename T, int KC, int V>
__device__ __forceinline__ void load_row(const T* p, int kc, T* o) {
  if constexpr (V == 1) {
#pragma unroll
    for (int q = 0; q < KC; ++q) o[q] = q < kc ? __ldg(p + q) : zero<T>();
  } else {
#pragma unroll
    for (int q = 0; q < KC; q += V) Io<T, V>::ld(p + q, o + q);
  }
}

template <typename T, int KC, int V>
__device__ __forceinline__ void store_row(T* p, int kc, const T* v) {
  if constexpr (V == 1) {
#pragma unroll
    for (int q = 0; q < KC; ++q)
      if (q < kc) p[q] = v[q];
  } else {
#pragma unroll
    for (int q = 0; q < KC; q += V) Io<T, V>::st(p + q, v + q);
  }
}

// U entries at once: their cols/vals first, then U independent gathers of
// X, then the fmas in slot order.
template <typename T, int KC, int V, int U>
__device__ __forceinline__ void step(const int* c, const T* v, const T* X,
                                     long k, int kc, T* acc) {
  int cc[U];
  T vv[U];
  T xx[U][KC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cc[u] = c[u * kSlice];
    vv[u] = v[u * kSlice];
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    load_row<T, KC, V>(X + static_cast<long long>(cc[u]) * k, kc, xx[u]);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = fma_t(vv[u], xx[u][q], acc[q]);
}

// Adds cnt entries of this lane's row to acc; c and v point at the
// lane's first entry, the next one kSlice further (slot-major).
template <typename T, int KC, int V>
__device__ __forceinline__ void accumulate(const int* c, const T* v, int cnt,
                                           const T* X, long k, int kc,
                                           T* acc) {
  constexpr int U = KC <= 2 ? 8 : (KC == 4 ? 4 : 2);   // gathers in flight
  int j = 0;
  for (; j + U <= cnt; j += U)
    step<T, KC, V, U>(c + j * kSlice, v + j * kSlice, X, k, kc, acc);
  for (; j < cnt; ++j)
    step<T, KC, V, 1>(c + j * kSlice, v + j * kSlice, X, k, kc, acc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// waits until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(policy)
      : "memory");
}

template <typename T>
struct Ring {
  static constexpr int kChunkT = kChunkOf<T>;
  static constexpr int kStageEntries = kWarps * kChunkT * kSlice;
  static constexpr int kStageBytes = kStageEntries * (4 + int(sizeof(T)));
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kBytes <= 232448, "the ring exceeds a block's shared memory");
  // stage s: cols [kWarps][kChunk*32] i32, then vals [kWarps][kChunk*32] T
  __device__ static int* cols(unsigned char* smem, int s, int w) {
    return reinterpret_cast<int*>(smem + s * kStageBytes) +
           w * kChunkT * kSlice;
  }
  __device__ static T* vals(unsigned char* smem, int s, int w) {
    return reinterpret_cast<T*>(smem + s * kStageBytes +
                                kStageEntries * 4) + w * kChunkT * kSlice;
  }
};

// The width (slots) of slice i, 0 past the last slice.
__device__ __forceinline__ int slice_width(const long long* slice_ptr, int i,
                                           int nslices) {
  return i < nslices ? int((slice_ptr[i + 1] - slice_ptr[i]) / kSlice) : 0;
}

template <typename T, int KC, int V>
__global__ void __launch_bounds__((kWarps + 1) * 32, 1)
sliced_ell_spmm(const long long* __restrict__ slice_ptr,
                const int* __restrict__ rowlen, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ X,
                T* __restrict__ Y, int n, int k, int kc, int ngroups) {
  extern __shared__ __align__(128) unsigned char smem[];
  using R = Ring<T>;
  constexpr int kChunk = R::kChunkT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * R::kStageBytes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nslices = (n + kSlice - 1) / kSlice;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);             // the producer's expect_tx
      mbar_init(&empty[s], kWarps);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // this block's groups of kWarps slices: a contiguous range
  const int g0 = int((long long)ngroups * blockIdx.x / gridDim.x);
  const int g1 = int((long long)ngroups * (blockIdx.x + 1) / gridDim.x);

  if (warp == kWarps) {                   // producer: one thread
    if (lane != 0) return;
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    int stage = 0;
    uint32_t parity = 1;                  // the ring starts empty
    for (int g = g0; g < g1; ++g) {
      long long e0[kWarps];
      int wd[kWarps], wmax = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int i = g * kWarps + w;
        wd[w] = slice_width(slice_ptr, i, nslices);
        e0[w] = wd[w] > 0 ? slice_ptr[i] : 0;
        wmax = max(wmax, wd[w]);
      }
      for (int j0 = 0; j0 < wmax; j0 += kChunk) {
        mbar_wait(&empty[stage], parity);
        uint32_t bytes = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          bytes += uint32_t(max(0, min(kChunk, wd[w] - j0))) * kSlice *
                   (4 + sizeof(T));
        mbar_expect_tx(&full[stage], bytes);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int cnt = min(kChunk, wd[w] - j0);
          if (cnt <= 0) continue;
          const long long e = e0[w] + (long long)kSlice * j0;
          bulk_load(R::cols(smem, stage, w), cols + e,
                    uint32_t(cnt) * kSlice * 4, &full[stage], policy);
          bulk_load(R::vals(smem, stage, w), vals + e,
                    uint32_t(cnt) * kSlice * sizeof(T), &full[stage], policy);
        }
        if (++stage == kStages) { stage = 0; parity ^= 1; }
      }
    }
    return;
  }

  // consumers: warp `warp` sums slice g*kWarps + warp of each group
  int stage = 0;
  uint32_t parity = 0;
  for (int g = g0; g < g1; ++g) {
    const int i = g * kWarps + warp;
    const int row = i * kSlice + lane;
    const int len = row < n ? rowlen[row] : 0;
    const int wl = lane < kWarps ? slice_width(slice_ptr, g * kWarps + lane,
                                               nslices) : 0;
    const int wmax = __reduce_max_sync(0xffffffffu, wl);
    T acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = zero<T>();
    for (int j0 = 0; j0 < wmax; j0 += kChunk) {
      mbar_wait(&full[stage], parity);
      accumulate<T, KC, V>(R::cols(smem, stage, warp) + lane,
                           R::vals(smem, stage, warp) + lane,
                           min(kChunk, len - j0), X, k, kc, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) { stage = 0; parity ^= 1; }
    }
    if (row < n) store_row<T, KC, V>(Y + (long)row * k, kc, acc);
  }
}

template <typename T, int KC, int V>
cudaError_t launch(const long long* slice_ptr, const int* rowlen,
                   const int* cols, const T* vals, const T* X, T* Y, int n,
                   int k, int kc, cudaStream_t st) {
  auto kern = sliced_ell_spmm<T, KC, V>;
  constexpr int kThreads = (kWarps + 1) * 32;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // resident blocks per SM, and the shared-memory attribute, per device
  static int cached[kMaxDevices] = {};
  int per_sm = dev < kMaxDevices ? cached[dev] : 0;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kThreads, Ring<T>::kBytes);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) cached[dev] = per_sm;
  }
  const int nslices = (n + kSlice - 1) / kSlice;
  const int ngroups = (nslices + kWarps - 1) / kWarps;
  const int grid = ngroups < sms * per_sm ? ngroups : sms * per_sm;
  kern<<<grid, kThreads, Ring<T>::kBytes, st>>>(
      slice_ptr, rowlen, cols, vals, X, Y, n, k, kc, ngroups);
  return cudaGetLastError();
}

// One launch per chunk of up to kMaxKC columns; vector gathers (V > 1)
// where the chunk is whole and every row of X and Y is V-aligned (none for
// complex128, whose one column is 16 bytes).
template <typename T>
int spmm(const long long* slice_ptr, const int* rowlen, const int* cols,
         const T* vals, const T* X, T* Y, int n, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);    // elements in 16 bytes
  constexpr int kV2 = kVec < 2 ? kVec : 2;
  for (int j0 = 0; j0 < k; j0 += kMaxKC) {
    const int kc = k - j0 < kMaxKC ? k - j0 : kMaxKC;
    const T* Xc = X + j0;
    T* Yc = Y + j0;
    const int v = kc < kVec ? kc : kVec;
    const bool vec = kVec > 1 && (kc == 2 || kc == 4 || kc == 8) &&
                     k % v == 0 &&
                     reinterpret_cast<uintptr_t>(Xc) % (v * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(Yc) % (v * sizeof(T)) == 0;
    cudaError_t err;
    if (kc == 1)
      err = launch<T, 1, 1>(slice_ptr, rowlen, cols, vals, Xc, Yc, n, k, kc, st);
    else if (kc == 2)
      err = vec ? launch<T, 2, kV2>(slice_ptr, rowlen, cols, vals, Xc, Yc, n,
                                    k, kc, st)
                : launch<T, 2, 1>(slice_ptr, rowlen, cols, vals, Xc, Yc, n, k,
                                  kc, st);
    else if (kc <= 4)
      err = vec ? launch<T, 4, kVec>(slice_ptr, rowlen, cols, vals, Xc, Yc, n,
                                     k, kc, st)
                : launch<T, 4, 1>(slice_ptr, rowlen, cols, vals, Xc, Yc, n, k,
                                  kc, st);
    else
      err = vec ? launch<T, 8, kVec>(slice_ptr, rowlen, cols, vals, Xc, Yc, n,
                                     k, kc, st)
                : launch<T, 8, 1>(slice_ptr, rowlen, cols, vals, Xc, Yc, n, k,
                                  kc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// X and Y are row-major [n, k] in the type of vals (complex: interleaved
// (re, im) pairs); each entry point returns the first CUDA error of its
// launches as an int (0: none).
extern "C" int windowed_ell_spmm_f32(const long long* slice_ptr,
                                     const int* rowlen, const int* cols,
                                     const float* vals, const float* X,
                                     float* Y, int n, int k, void* stream) {
  return spmm<float>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}

extern "C" int windowed_ell_spmm_f64(const long long* slice_ptr,
                                     const int* rowlen, const int* cols,
                                     const double* vals, const double* X,
                                     double* Y, int n, int k, void* stream) {
  return spmm<double>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}

extern "C" int windowed_ell_spmm_c64(const long long* slice_ptr,
                                     const int* rowlen, const int* cols,
                                     const float2* vals, const float2* X,
                                     float2* Y, int n, int k, void* stream) {
  return spmm<float2>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}

extern "C" int windowed_ell_spmm_c128(const long long* slice_ptr,
                                      const int* rowlen, const int* cols,
                                      const double2* vals, const double2* X,
                                      double2* Y, int n, int k, void* stream) {
  return spmm<double2>(slice_ptr, rowlen, cols, vals, X, Y, n, k, stream);
}
