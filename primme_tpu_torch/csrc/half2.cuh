// Packed half arithmetic for the 16-bit entry points of dia.cu and
// stencil3d.cu: two f16 (or two bf16) values a 32-bit word, the lower
// address (a lower row, column or point) in the low 16 bits, as a __half2
// or __nv_bfloat162 holds them in memory.
//
// Each operation is one PTX instruction with an explicit .rn: the correctly
// rounded IEEE half operation on each lane (subnormals kept, as the f16
// and bf16 forms of add, sub and mul do without .ftz), which is what f32
// arithmetic on the exact half operands rounded once to the half type
// gives, since f32 holds more than twice a half's significand plus two
// bits (24 >= 2 * 11 + 2 for f16, 24 >= 2 * 8 + 2 for bf16); so a packed
// kernel equals torch's half arithmetic (which computes in f32 and
// rounds) bit for bit. The .rn also keeps ptxas from contracting a
// multiply and an add into one fma (one rounding where the plain version
// rounds twice), which the unsuffixed __hmul2 / __hadd2 allow. The bf16x2
// forms need sm_90. tools/half_packed_check.cu holds these operations to
// f32-then-round on every pair of 16-bit patterns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace half2ops {

// a * b, a + b, a - b on both lanes of the words of half type H
template <typename H> struct Packed;

template <> struct Packed<__half> {
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
    unsigned d;
    asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

template <> struct Packed<__nv_bfloat16> {
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
    unsigned d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// the word of two halves lo, hi (raw bits)
__host__ __device__ __forceinline__ unsigned pack(unsigned short lo,
                                                  unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// the high half of lo and the low half of hi: the pair one half past lo's
__device__ __forceinline__ unsigned shift_pair(unsigned lo, unsigned hi) {
  return __byte_perm(lo, hi, 0x5432);
}

// N adjacent halves at p (any 2-byte aligned address) into N / 2 words
// (N even), in memory order. Aligned to 4 bytes: the widest loads of 16,
// 8 or 4 bytes that the address and N allow; else N / 2 + 1 aligned
// 4-byte loads from the half below p, each word made of two of them with
// a byte permute (the half below p and the one past its end lie in the
// aligned words of halves in the range, so within the allocation).
template <int N>
__device__ __forceinline__ void ld_halves(const unsigned short* p,
                                          unsigned* w) {
  static_assert(N % 2 == 0 && N >= 2 && N <= 16, "N halves: 2 to 16, even");
  const unsigned a = static_cast<unsigned>(reinterpret_cast<size_t>(p));
  if ((a & 3) == 0) {
    if constexpr (N >= 8) {
      if ((a & 15) == 0) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
          w[4 * i] = v.x; w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
        }
        return;
      }
    }
    if constexpr (N >= 4) {
      if ((a & 7) == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
          w[2 * i] = v.x; w[2 * i + 1] = v.y;
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(p - 1);
    unsigned lo = __ldg(q);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const unsigned hi = __ldg(q + i + 1);
      w[i] = shift_pair(lo, hi);
      lo = hi;
    }
  }
}

// N adjacent halves at p, aligned to 2 N bytes (N = 2, 4 or 8), in one
// load into N / 2 words
template <int N>
__device__ __forceinline__ void ld_aligned(const unsigned short* p,
                                           unsigned* w) {
  static_assert(N == 2 || N == 4 || N == 8, "one load of 4, 8 or 16 bytes");
  if constexpr (N == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// KC adjacent halves at p (KC even) into KC / 2 words, VW halves a load
// (p aligned to 2 VW bytes; VW = 1: scalar loads, paired)
template <int KC, int VW>
__device__ __forceinline__ void ld_row(const unsigned short* p, unsigned* w) {
  if constexpr (VW == 1) {
#pragma unroll
    for (int c = 0; c < KC; c += 2)
      w[c / 2] = pack(__ldg(p + c), __ldg(p + c + 1));
  } else {
#pragma unroll
    for (int c = 0; c < KC; c += VW) ld_aligned<VW>(p + c, w + c / 2);
  }
}

// N / 2 words to N adjacent halves at p, aligned to 2 N bytes up to 16
template <int N>
__device__ __forceinline__ void st_halves(unsigned short* p,
                                          const unsigned* w) {
  static_assert(N % 2 == 0 && N >= 2 && N <= 16, "N halves: 2 to 16, even");
  if constexpr (N >= 8) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

}  // namespace half2ops
