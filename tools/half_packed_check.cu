// The packed half operations of the port's kernels (primme_tpu_torch/
// csrc/half2.cuh: mul.rn, add.rn, sub.rn on f16x2 and bf16x2) against f32
// arithmetic on the exact half operands rounded once to the half type (the
// arithmetic of torch's half operations and of the earlier kernels), on
// every pair of 16-bit patterns: 2^32 pairs for each of f16 and bf16 and
// each of the three operations. A result pair matches when both are NaN,
// or when their bits are equal (so +0 and -0 differ, as do a subnormal
// and zero). Built and run by chip_smoke.py::half_packed_check (phase 48)
// and tests/test_torch_half_packed_cuda.py, on the card only.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "../primme_tpu_torch/csrc/half2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOps = 3;        // mul, add, sub
constexpr int kCounts = 3;     // mismatches, both NaN, NaN bits differ

template <typename H>
__device__ __forceinline__ float widen(unsigned short h) {
  if constexpr (std::is_same<H, __half>::value)
    return __half2float(__ushort_as_half(h));
  else
    return __bfloat162float(__ushort_as_bfloat16(h));
}

template <typename H>
__device__ __forceinline__ unsigned short narrow(float f) {
  if constexpr (std::is_same<H, __half>::value)
    return __half_as_ushort(__float2half_rn(f));
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <typename H>
__device__ __forceinline__ bool is_nan(unsigned short h) {
  if constexpr (std::is_same<H, __half>::value)
    return (h & 0x7c00) == 0x7c00 && (h & 0x03ff) != 0;
  else
    return (h & 0x7f80) == 0x7f80 && (h & 0x007f) != 0;
}

// f32 on the exact operands, one rounding to H
template <typename H>
__device__ __forceinline__ unsigned short reference(int op, float a,
                                                    float b) {
  const float r = op == 0 ? __fmul_rn(a, b)
                          : op == 1 ? __fadd_rn(a, b) : __fsub_rn(a, b);
  return narrow<H>(r);
}

template <typename H>
__device__ __forceinline__ unsigned packed(int op, unsigned a, unsigned b) {
  using P = half2ops::Packed<H>;
  return op == 0 ? P::mul(a, b) : op == 1 ? P::add(a, b) : P::sub(a, b);
}

// Block a checks the pairs (a, b) for every b, two b a thread a step
// (the two lanes); counts[t][op][c] gathers the block's counts, first[t *
// kOps + op] the first mismatching pair found (a << 16 | b), else ~0.
template <typename H>
__device__ __forceinline__ void check_type(unsigned a, int t,
                                           unsigned long long* counts,
                                           unsigned* first) {
  const unsigned a2 = half2ops::pack(a, a);
  const float fa = widen<H>(static_cast<unsigned short>(a));
#pragma unroll
  for (int op = 0; op < kOps; ++op) {
    unsigned c[kCounts] = {0, 0, 0};
    for (unsigned b = 2 * threadIdx.x; b < 65536; b += 2 * kThreads) {
      const unsigned got = packed<H>(op, a2, half2ops::pack(b, b + 1));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned short x = static_cast<unsigned short>(got >> (16 * e));
        const unsigned short y =
            reference<H>(op, fa, widen<H>(static_cast<unsigned short>(b + e)));
        const bool both_nan = is_nan<H>(x) && is_nan<H>(y);
        const bool bad = !both_nan && x != y;
        c[0] += bad;
        c[1] += both_nan;
        c[2] += both_nan && x != y;
        if (bad) atomicCAS(first + t * kOps + op, ~0u, (a << 16) | (b + e));
      }
    }
#pragma unroll
    for (int q = 0; q < kCounts; ++q) {
      unsigned v = c[q];
#pragma unroll
      for (int s = 16; s > 0; s /= 2) v += __shfl_down_sync(~0u, v, s);
      if (threadIdx.x % 32 == 0 && v)
        atomicAdd(counts + (t * kOps + op) * kCounts + q,
                  static_cast<unsigned long long>(v));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    half_packed_kernel(unsigned long long* counts, unsigned* first) {
  check_type<__half>(blockIdx.x, 0, counts, first);
  check_type<__nv_bfloat16>(blockIdx.x, 1, counts, first);
}

}  // namespace

// counts: 2 x 3 x 3 zeroed u64 (type f16, bf16; op mul, add, sub;
// mismatches, both NaN, both NaN with other bits); first: 6 u32 set to
// ~0. Returns the CUDA error of the launch (0: none).
extern "C" int half_packed_check(unsigned long long* counts, unsigned* first,
                                 void* stream) {
  half_packed_kernel<<<65536, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(counts, first);
  return static_cast<int>(cudaGetLastError());
}
