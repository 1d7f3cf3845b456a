// Sparse product Y = A X for Hopper (sm_90a), in f32, f64, f16, bf16,
// complex64 and complex128, on the warp-sliced ELL layout that
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
// Narrow slices (the direct path). Where slices hold a few slots (rows of
// 1-2 entries: svds' incidence A; of ~10 scattered ones: the scatters), a
// group is one or two short stages and a block's single producer reads
// slice_ptr before it can issue each group's copies, while the ring's
// 4 x 40-49 KB and
// __launch_bounds__(..., 1) leave one block (8 consumer warps) on an SM:
// every group is a chain of dependent latencies (slice_ptr, the barrier,
// the X gathers, the store) with little else in flight. The direct path
// takes the ring away: blocks of kDirectWarps warps, one slice a warp,
// each lane reading its row's cols/vals straight from device memory
// (coalesced: entry j of a slice's 32 rows is one line), no shared
// memory, so up to 64 warps sit on an SM and their chains overlap. It
// runs the same consumer loop (accumulate) in the same slot order, so
// the two paths give the same sums bit for bit. The wrapper
// (ops/windowed_ell.py::choose_path) picks the path per layout from its
// mean slice width, E / (32 slices), known from the arrays' shapes; wide
// layouts keep the ring. On both paths a row's last entries (fewer than
// the gathers a step holds) go in halving steps, not one a slot: a row of
// 7 takes three rounds of gathers, not seven.
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
//
// The 16-bit entry points (windowed_ell_spmm_f16, _bf16) serve a half
// ELLOperator on from_csr's layout, the counterpart of the reference's
// einsum of half vals with the gathered half X (:198-207), which XLA sums
// in f32 and rounds once to the half type. Here too: each lane's sum is
// an f32 fma chain over the exact f32 values of its half entries, in
// slot order, rounded once to the half type when it is stored. The plain
// version sums the same terms in the same order with a rounded product
// and sum in f32, so the two differ in f32's last bits and, after the
// one rounding, by at most one unit in the half's last place. vals and X
// are 2 bytes an element (cols stay 4): 6 bytes a non-zero against 8 in
// f32. X rows go in vectors of up to eight halves (16 bytes).
//
// The mixed entry points (windowed_ell_spmm_f16_f32, _bf16_f32, _f16_f64,
// _bf16_f64) serve a half ELLOperator given a wider real block (a half
// basis hands it f32 blocks), where the reference's einsum promotes to the
// block's type: the ring and the lanes read the half values (VT), each
// widened exactly into the fma chain of the block's type (T), so the sum
// equals the f32 (f64) kernel's on the widened values bit for bit while a
// non-zero moves 6 bytes, not 8 (12).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
constexpr int kDirectWarps = 8;         // slices of a direct-path block
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

// a half entry's term: its exact f32 values, summed in f32
__device__ __forceinline__ float fma_t(__half a, __half b, float c) {
  return fmaf(__half2float(a), __half2float(b), c);
}
__device__ __forceinline__ float fma_t(__nv_bfloat16 a, __nv_bfloat16 b,
                                       float c) {
  return fmaf(__bfloat162float(a), __bfloat162float(b), c);
}

// a half value's term in a wider block's sum: its exact value, widened
__device__ __forceinline__ float fma_t(__half a, float b, float c) {
  return fmaf(__half2float(a), b, c);
}
__device__ __forceinline__ float fma_t(__nv_bfloat16 a, float b, float c) {
  return fmaf(__bfloat162float(a), b, c);
}
__device__ __forceinline__ double fma_t(__half a, double b, double c) {
  return fma(static_cast<double>(__half2float(a)), b, c);
}
__device__ __forceinline__ double fma_t(__nv_bfloat16 a, double b,
                                        double c) {
  return fma(static_cast<double>(__bfloat162float(a)), b, c);
}

// The type a lane sums in: T's own, f32 for a half type
template <typename T> struct Acc { using type = T; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
// a sum as T: one rounding for a half type
template <typename T>
__device__ __forceinline__ T to_t(typename Acc<T>::type a) { return a; }
template <>
__device__ __forceinline__ __half to_t<__half>(float a) {
  return __float2half_rn(a);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
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

// V halves (V = 2, 4, 8) as one load of 4, 8 or 16 bytes
template <int V> struct Bits16;
template <> struct Bits16<2> { using type = unsigned int; };
template <> struct Bits16<4> { using type = uint2; };
template <> struct Bits16<8> { using type = uint4; };
template <typename H, int V> struct IoHalf {
  using B = typename Bits16<V>::type;
  static __device__ __forceinline__ void ld(const H* p, H* o) {
    const B v = __ldg(reinterpret_cast<const B*>(p));
    const H* e = reinterpret_cast<const H*>(&v);
#pragma unroll
    for (int q = 0; q < V; ++q) o[q] = e[q];
  }
};
template <int V> struct Io<__half, V> : IoHalf<__half, V> {};
template <int V> struct Io<__nv_bfloat16, V> : IoHalf<__nv_bfloat16, V> {};

// one element of T through the read-only path
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

// KC columns of one X row (kc of them real when V == 1; V > 1 means
// kc == KC and aligned rows).
template <typename T, int KC, int V>
__device__ __forceinline__ void load_row(const T* p, int kc, T* o) {
  if constexpr (V == 1) {
#pragma unroll
    for (int q = 0; q < KC; ++q) o[q] = q < kc ? ldg1(p + q) : zero<T>();
  } else {
#pragma unroll
    for (int q = 0; q < KC; q += V) Io<T, V>::ld(p + q, o + q);
  }
}

// the row's sums as T (one rounding for a half type); V > 1: whole
// aligned vectors
template <typename T, int KC, int V>
__device__ __forceinline__ void store_row(T* p, int kc,
                                          const typename Acc<T>::type* a) {
  T v[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) v[q] = to_t<T>(a[q]);
  if constexpr (V == 1) {
#pragma unroll
    for (int q = 0; q < KC; ++q)
      if (q < kc) p[q] = v[q];
  } else if constexpr (sizeof(T) == 2) {
    using B = typename Bits16<V>::type;
#pragma unroll
    for (int q = 0; q < KC; q += V)
      *reinterpret_cast<B*>(p + q) = *reinterpret_cast<const B*>(v + q);
  } else {
#pragma unroll
    for (int q = 0; q < KC; q += V) Io<T, V>::st(p + q, v + q);
  }
}

// How a lane reads its cols/vals: plain loads, from the ring's shared
// memory or (the direct path) from device memory. Streaming, read-only
// and L2-only loads measured no better on the direct path
// (tools/torch_kernel_variants.py, which instantiates them).
struct Plain {
  template <typename E>
  static __device__ __forceinline__ E ld(const E* p) { return *p; }
};

// U entries at once: their cols/vals first, then U independent gathers of
// X, then the fmas in slot order. Values are stored as VT (T, or a half
// type under a wider block).
template <typename T, int KC, int V, int U, typename Ld, typename VT>
__device__ __forceinline__ void step(const int* c, const VT* v, const T* X,
                                     long k, int kc,
                                     typename Acc<T>::type* acc) {
  int cc[U];
  VT vv[U];
  T xx[U][KC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cc[u] = Ld::ld(c + u * kSlice);
    vv[u] = Ld::ld(v + u * kSlice);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    load_row<T, KC, V>(X + static_cast<long long>(cc[u]) * k, kc, xx[u]);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = fma_t(vv[u], xx[u][q], acc[q]);
}

// The last r < 2 U entries of a row: U of them if r >= U, then the rest
// in steps of U / 2, U / 4, ..., 1, so that a remainder of r entries
// takes at most log2(U) + 1 rounds of gathers, not r (a step of U held
// for every remainder would hold its registers and cost occupancy).
template <typename T, int KC, int V, int U, typename Ld, typename VT>
__device__ __forceinline__ void tail(const int* c, const VT* v, int r,
                                     const T* X, long k, int kc,
                                     typename Acc<T>::type* acc) {
  if (r >= U) {
    step<T, KC, V, U, Ld, VT>(c, v, X, k, kc, acc);
    c += U * kSlice;
    v += U * kSlice;
    r -= U;
  }
  if constexpr (U > 1)
    tail<T, KC, V, U / 2, Ld, VT>(c, v, r, X, k, kc, acc);
}

// Adds cnt entries of this lane's row to acc; c and v point at the
// lane's first entry, the next one kSlice further (slot-major).
template <typename T, int KC, int V, typename Ld = Plain, typename VT = T>
__device__ __forceinline__ void accumulate(const int* c, const VT* v, int cnt,
                                           const T* X, long k, int kc,
                                           typename Acc<T>::type* acc) {
  constexpr int U = KC <= 2 ? 8 : (KC == 4 ? 4 : 2);   // gathers in flight
  int j = 0;
  for (; j + U <= cnt; j += U)
    step<T, KC, V, U, Ld, VT>(c + j * kSlice, v + j * kSlice, X, k, kc, acc);
  if (j < cnt)
    tail<T, KC, V, U / 2, Ld, VT>(c + j * kSlice, v + j * kSlice, cnt - j, X,
                                  k, kc, acc);
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

template <typename T, int KC, int V, typename VT = T>
__global__ void __launch_bounds__((kWarps + 1) * 32, 1)
sliced_ell_spmm(const long long* __restrict__ slice_ptr,
                const int* __restrict__ rowlen, const int* __restrict__ cols,
                const VT* __restrict__ vals, const T* __restrict__ X,
                T* __restrict__ Y, int n, int k, int kc, int ngroups) {
  extern __shared__ __align__(128) unsigned char smem[];
  using R = Ring<VT>;
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
                   (4 + sizeof(VT));
        mbar_expect_tx(&full[stage], bytes);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int cnt = min(kChunk, wd[w] - j0);
          if (cnt <= 0) continue;
          const long long e = e0[w] + (long long)kSlice * j0;
          bulk_load(R::cols(smem, stage, w), cols + e,
                    uint32_t(cnt) * kSlice * 4, &full[stage], policy);
          bulk_load(R::vals(smem, stage, w), vals + e,
                    uint32_t(cnt) * kSlice * sizeof(VT), &full[stage],
                    policy);
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
    typename Acc<T>::type acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = zero<typename Acc<T>::type>();
    for (int j0 = 0; j0 < wmax; j0 += kChunk) {
      mbar_wait(&full[stage], parity);
      accumulate<T, KC, V, Plain, VT>(R::cols(smem, stage, warp) + lane,
                                      R::vals(smem, stage, warp) + lane,
                                      min(kChunk, len - j0), X, k, kc, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) { stage = 0; parity ^= 1; }
    }
    if (row < n) store_row<T, KC, V>(Y + (long)row * k, kc, acc);
  }
}

// The direct path: warp `w` of block b sums slice b * kDirectWarps + w,
// each lane its row, reading cols/vals from device memory through Ld.
template <typename T, int KC, int V, typename Ld = Plain, typename VT = T>
__global__ void __launch_bounds__(kDirectWarps * 32)
sliced_ell_direct(const long long* __restrict__ slice_ptr,
                  const int* __restrict__ rowlen, const int* __restrict__ cols,
                  const VT* __restrict__ vals, const T* __restrict__ X,
                  T* __restrict__ Y, int n, int k, int kc) {
  const int i = blockIdx.x * kDirectWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = i * kSlice + lane;
  if (row >= n) return;
  const long long e = slice_ptr[i] + lane;
  typename Acc<T>::type acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = zero<typename Acc<T>::type>();
  accumulate<T, KC, V, Ld, VT>(cols + e, vals + e, rowlen[row], X, k, kc,
                               acc);
  store_row<T, KC, V>(Y + (long)row * k, kc, acc);
}

template <typename T, int KC, int V, typename VT>
cudaError_t launch(const long long* slice_ptr, const int* rowlen,
                   const int* cols, const VT* vals, const T* X, T* Y, int n,
                   int k, int kc, bool direct, cudaStream_t st) {
  if (direct) {
    const int nslices = (n + kSlice - 1) / kSlice;
    sliced_ell_direct<T, KC, V, Plain, VT>
        <<<(nslices + kDirectWarps - 1) / kDirectWarps, kDirectWarps * 32, 0,
           st>>>(slice_ptr, rowlen, cols, vals, X, Y, n, k, kc);
    return cudaGetLastError();
  }
  auto kern = sliced_ell_spmm<T, KC, V, VT>;
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
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<VT>::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kThreads, Ring<VT>::kBytes);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) cached[dev] = per_sm;
  }
  const int nslices = (n + kSlice - 1) / kSlice;
  const int ngroups = (nslices + kWarps - 1) / kWarps;
  const int grid = ngroups < sms * per_sm ? ngroups : sms * per_sm;
  kern<<<grid, kThreads, Ring<VT>::kBytes, st>>>(
      slice_ptr, rowlen, cols, vals, X, Y, n, k, kc, ngroups);
  return cudaGetLastError();
}

// One launch per chunk of up to kMaxKC columns, on the direct path or the
// ring; vector gathers (V > 1) where the chunk is whole and every row of X
// and Y is V-aligned (none for complex128, whose one column is 16 bytes).
template <typename T, typename VT = T>
int spmm(const long long* slice_ptr, const int* rowlen, const int* cols,
         const VT* vals, const T* X, T* Y, int n, int k, int direct,
         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);    // elements in 16 bytes
  constexpr int kV2 = kVec < 2 ? kVec : 2;
  constexpr int kV4 = kVec < 4 ? kVec : 4;
  const bool d = direct != 0;
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
      err = launch<T, 1, 1, VT>(slice_ptr, rowlen, cols, vals, Xc, Yc, n, k,
                                kc, d, st);
    else if (kc == 2)
      err = vec ? launch<T, 2, kV2, VT>(slice_ptr, rowlen, cols, vals, Xc,
                                        Yc, n, k, kc, d, st)
                : launch<T, 2, 1, VT>(slice_ptr, rowlen, cols, vals, Xc, Yc,
                                      n, k, kc, d, st);
    else if (kc <= 4)
      err = vec ? launch<T, 4, kV4, VT>(slice_ptr, rowlen, cols, vals, Xc,
                                        Yc, n, k, kc, d, st)
                : launch<T, 4, 1, VT>(slice_ptr, rowlen, cols, vals, Xc, Yc,
                                      n, k, kc, d, st);
    else
      err = vec ? launch<T, 8, kVec, VT>(slice_ptr, rowlen, cols, vals, Xc,
                                         Yc, n, k, kc, d, st)
                : launch<T, 8, 1, VT>(slice_ptr, rowlen, cols, vals, Xc, Yc,
                                      n, k, kc, d, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// X and Y are row-major [n, k] in the type of vals (complex: interleaved
// (re, im) pairs; the mixed entry points, <half>_<block>: half vals, X and
// Y in the block's type); `direct` nonzero runs the direct path, 0 the
// ring. Each entry point returns the first CUDA error of its launches as
// an int (0: none).
#define SPMM_ENTRY(T, SUFFIX)                                                \
  extern "C" int windowed_ell_spmm_##SUFFIX(                                 \
      const long long* slice_ptr, const int* rowlen, const int* cols,        \
      const T* vals, const T* X, T* Y, int n, int k, int direct,             \
      void* stream) {                                                        \
    return spmm<T>(slice_ptr, rowlen, cols, vals, X, Y, n, k, direct,        \
                   stream);                                                  \
  }

SPMM_ENTRY(float, f32)
SPMM_ENTRY(double, f64)
SPMM_ENTRY(__half, f16)
SPMM_ENTRY(__nv_bfloat16, bf16)
SPMM_ENTRY(float2, c64)
SPMM_ENTRY(double2, c128)

#define SPMM_MIXED(VT, T, SUFFIX)                                            \
  extern "C" int windowed_ell_spmm_##SUFFIX(                                 \
      const long long* slice_ptr, const int* rowlen, const int* cols,        \
      const VT* vals, const T* X, T* Y, int n, int k, int direct,            \
      void* stream) {                                                        \
    return spmm<T, VT>(slice_ptr, rowlen, cols, vals, X, Y, n, k, direct,    \
                       stream);                                              \
  }

SPMM_MIXED(__half, float, f16_f32)
SPMM_MIXED(__nv_bfloat16, float, bf16_f32)
SPMM_MIXED(__half, double, f16_f64)
SPMM_MIXED(__nv_bfloat16, double, bf16_f64)
#undef SPMM_MIXED
