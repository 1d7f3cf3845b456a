// Variants of the mixed DIA product (bf16 values widened to f32, an f32
// block of k = 2 columns, matmat) for timing the thread maps and offset
// schemes against one another: the measurement behind the design of
// primme_tpu_torch/csrc/dia.cu::dia_mixed_kernel. Every variant keeps the
// arithmetic of dia_kernel (one rounding an operation, stored order, v * 0
// off the edge), so all of them agree bit for bit. Built and run by
// tools/torch_mixed_dia_variants.py, on the card only; not part of the
// port.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 256;

__device__ __forceinline__ float wv(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ void madd2(float* a, float v, float2 x, bool in) {
  a[0] = __fadd_rn(a[0], __fmul_rn(v, in ? x.x : 0.f));
  a[1] = __fadd_rn(a[1], __fmul_rn(v, in ? x.y : 0.f));
}

// A: dia_kernel's loop: one row a thread, i64 offsets loaded from device
// memory for each diagonal, the loop unrolled four times
__global__ void __launch_bounds__(kT)
    one_row_global(const unsigned short* __restrict__ V,
                   const long long* __restrict__ offs,
                   const int* __restrict__ o32, int B,
                   const float* __restrict__ X, float* __restrict__ Y, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * kT + threadIdx.x;
  if (i >= n) return;
  float a[2] = {0.f, 0.f};
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const long long j = i + __ldg(offs + b);
    const bool in = j >= 0 && j < n;
    madd2(a, wv(__ldg(V + static_cast<long long>(b) * n + i)),
          __ldg(reinterpret_cast<const float2*>(X) + (in ? j : i)), in);
  }
  reinterpret_cast<float2*>(Y)[i] = make_float2(a[0], a[1]);
}

// B: one row a thread, i32 offsets staged once a block in shared memory
__global__ void __launch_bounds__(kT)
    one_row_shared(const unsigned short* __restrict__ V,
                   const long long* __restrict__ offs,
                   const int* __restrict__ o32, int B,
                   const float* __restrict__ X, float* __restrict__ Y, int n) {
  __shared__ int sh[kT];
  const int i = blockIdx.x * kT + threadIdx.x;
  if (threadIdx.x < B) sh[threadIdx.x] = o32[threadIdx.x];
  __syncthreads();
  if (i >= n) return;
  float a[2] = {0.f, 0.f};
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const int j = i + sh[b];
    const bool in = j >= 0 && j < n;
    madd2(a, wv(__ldg(V + static_cast<long long>(b) * n + i)),
          __ldg(reinterpret_cast<const float2*>(X) + (in ? j : i)), in);
  }
  reinterpret_cast<float2*>(Y)[i] = make_float2(a[0], a[1]);
}

// C: one row a thread, the 27 offsets as kernel parameters (the constant
// bank) and the loop unrolled whole: needs the offsets on the host
struct Offs27 { int o[27]; };
__global__ void __launch_bounds__(kT)
    one_row_params(const unsigned short* __restrict__ V, const Offs27 so,
                   const float* __restrict__ X, float* __restrict__ Y, int n) {
  const int i = blockIdx.x * kT + threadIdx.x;
  if (i >= n) return;
  float a[2] = {0.f, 0.f};
#pragma unroll
  for (int b = 0; b < 27; ++b) {
    const int j = i + so.o[b];
    const bool in = j >= 0 && j < n;
    madd2(a, wv(__ldg(V + static_cast<long long>(b) * n + i)),
          __ldg(reinterpret_cast<const float2*>(X) + (in ? j : i)), in);
  }
  reinterpret_cast<float2*>(Y)[i] = make_float2(a[0], a[1]);
}

// D: two adjacent rows a thread (n even), shared offsets: the two values
// in one 4-byte load, the two rows of X in one 16-byte load where the
// shift is even, two 8-byte loads where it is odd
__global__ void __launch_bounds__(kT)
    two_adjacent(const unsigned short* __restrict__ V,
                 const long long* __restrict__ offs,
                 const int* __restrict__ o32, int B,
                 const float* __restrict__ X, float* __restrict__ Y, int n) {
  __shared__ int sh[kT];
  const int i0 = (blockIdx.x * kT + threadIdx.x) * 2;
  if (threadIdx.x < B) sh[threadIdx.x] = o32[threadIdx.x];
  __syncthreads();
  if (i0 >= n) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const int off = sh[b];
    const int j0 = i0 + off;
    const unsigned v2 = __ldg(reinterpret_cast<const unsigned*>(
        V + static_cast<long long>(b) * n + i0));
    float2 x[2];
    bool in[2];
    if (j0 >= 0 && j0 + 2 <= n) {
      in[0] = in[1] = true;
      if ((off & 1) == 0) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(X + 2LL * j0));
        x[0] = make_float2(t.x, t.y);
        x[1] = make_float2(t.z, t.w);
      } else {
        x[0] = __ldg(reinterpret_cast<const float2*>(X) + j0);
        x[1] = __ldg(reinterpret_cast<const float2*>(X) + j0 + 1);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + r;
        in[r] = j >= 0 && j < n;
        x[r] = __ldg(reinterpret_cast<const float2*>(X) + (in[r] ? j : i0 + r));
      }
    }
    madd2(a, __uint_as_float(v2 << 16), x[0], in[0]);
    madd2(a + 2, __uint_as_float(v2 & 0xffff0000u), x[1], in[1]);
  }
  reinterpret_cast<float4*>(Y)[i0 / 2] = make_float4(a[0], a[1], a[2], a[3]);
}

// H: four adjacent rows a thread (n a multiple of 4), shared offsets: the
// four values in one 8-byte load, the four rows of X as two 16-byte chunks
// where the shift is even, three and a select where it is odd
__global__ void __launch_bounds__(kT)
    four_adjacent(const unsigned short* __restrict__ V,
                  const long long* __restrict__ offs,
                  const int* __restrict__ o32, int B,
                  const float* __restrict__ X, float* __restrict__ Y, int n) {
  __shared__ int sh[kT];
  const int i0 = (blockIdx.x * kT + threadIdx.x) * 4;
  if (threadIdx.x < B) sh[threadIdx.x] = o32[threadIdx.x];
  __syncthreads();
  if (i0 >= n) return;
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const int off = sh[b];
    const int j0 = i0 + off;
    const uint2 v4 = __ldg(reinterpret_cast<const uint2*>(
        V + static_cast<long long>(b) * n + i0));
    float x[8];
    bool in[4];
    if (j0 >= 0 && j0 + 4 <= n) {
      in[0] = in[1] = in[2] = in[3] = true;
      const float4* p = reinterpret_cast<const float4*>(X + 2LL * (j0 - (off & 1)));
      const float4 c0 = __ldg(p), c1 = __ldg(p + 1);
      if ((off & 1) == 0) {
        x[0] = c0.x; x[1] = c0.y; x[2] = c0.z; x[3] = c0.w;
        x[4] = c1.x; x[5] = c1.y; x[6] = c1.z; x[7] = c1.w;
      } else {
        const float4 c2 = __ldg(p + 2);
        x[0] = c0.z; x[1] = c0.w; x[2] = c1.x; x[3] = c1.y;
        x[4] = c1.z; x[5] = c1.w; x[6] = c2.x; x[7] = c2.y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        in[r] = j >= 0 && j < n;
        const float2 t = __ldg(reinterpret_cast<const float2*>(X) + (in[r] ? j : i0 + r));
        x[2 * r] = t.x;
        x[2 * r + 1] = t.y;
      }
    }
    const float v[4] = {__uint_as_float(v4.x << 16),
                        __uint_as_float(v4.x & 0xffff0000u),
                        __uint_as_float(v4.y << 16),
                        __uint_as_float(v4.y & 0xffff0000u)};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      madd2(a + 2 * r, v[r], make_float2(x[2 * r], x[2 * r + 1]), in[r]);
  }
  float4* y = reinterpret_cast<float4*>(Y) + i0 / 2;
  y[0] = make_float4(a[0], a[1], a[2], a[3]);
  y[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// E: two rows 32 apart a thread (a warp's loads stay one run), shared
// offsets
__global__ void __launch_bounds__(kT)
    two_apart(const unsigned short* __restrict__ V,
              const long long* __restrict__ offs,
              const int* __restrict__ o32, int B,
              const float* __restrict__ X, float* __restrict__ Y, int n) {
  __shared__ int sh[kT];
  const int lane = threadIdx.x % 32;
  const int i0 = (blockIdx.x * kT + threadIdx.x - lane) * 2 + lane;
  if (threadIdx.x < B) sh[threadIdx.x] = o32[threadIdx.x];
  __syncthreads();
  if (i0 >= n) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const int off = sh[b];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 32 * r;
      const int j = i + off;
      const bool in = j >= 0 && j < n;
      madd2(a + 2 * r, wv(__ldg(V + static_cast<long long>(b) * n + i)),
            __ldg(reinterpret_cast<const float2*>(X) + (in ? j : i)), in);
    }
  }
  reinterpret_cast<float2*>(Y)[i0] = make_float2(a[0], a[1]);
  reinterpret_cast<float2*>(Y)[i0 + 32] = make_float2(a[2], a[3]);
}

// G<U>: one row a thread, shared offsets, the loads of U diagonals issued
// before any of them is summed; the last B % U one at a time
template <int U>
__global__ void __launch_bounds__(kT)
    one_row_staged(const unsigned short* __restrict__ V,
                   const long long* __restrict__ offs,
                   const int* __restrict__ o32, int B,
                   const float* __restrict__ X, float* __restrict__ Y, int n) {
  __shared__ int sh[kT];
  const int i = blockIdx.x * kT + threadIdx.x;
  if (threadIdx.x < B) sh[threadIdx.x] = o32[threadIdx.x];
  __syncthreads();
  if (i >= n) return;
  float a[2] = {0.f, 0.f};
  int b = 0;
  for (; b + U <= B; b += U) {
    float v[U];
    float2 x[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = i + sh[b + u];
      in[u] = j >= 0 && j < n;
      v[u] = wv(__ldg(V + static_cast<long long>(b + u) * n + i));
      x[u] = __ldg(reinterpret_cast<const float2*>(X) + (in[u] ? j : i));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) madd2(a, v[u], x[u], in[u]);
  }
  for (; b < B; ++b) {
    const int j = i + sh[b];
    const bool in = j >= 0 && j < n;
    madd2(a, wv(__ldg(V + static_cast<long long>(b) * n + i)),
          __ldg(reinterpret_cast<const float2*>(X) + (in ? j : i)), in);
  }
  reinterpret_cast<float2*>(Y)[i] = make_float2(a[0], a[1]);
}

}  // namespace

// The variant `v` (0 A, 1 B, 2 C, 3 D, 4 H, 5 E, 6-8 G<8, 9, 16>) on the
// bf16 values V [B, n], the offsets (i64 and i32 on the card, host_offs on
// the host; B <= 256, B = 27 for C; n even for D, a multiple of 4 for H
// and of 64 for E), an [n, 2] f32 X into Y; the CUDA error of the launch.
extern "C" int mixed_dia_variant(int v, const unsigned short* V,
                                 const long long* offs, const int* o32,
                                 const int* host_offs, int B, const float* X,
                                 float* Y, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g1 = (n + kT - 1) / kT;
  if (B < 1 || B > kT || (v == 2 && B != 27) || (v == 3 && n % 2) ||
      (v == 4 && n % 4) || (v == 5 && n % 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (v) {
    case 0: one_row_global<<<g1, kT, 0, s>>>(V, offs, o32, B, X, Y, n); break;
    case 1: one_row_shared<<<g1, kT, 0, s>>>(V, offs, o32, B, X, Y, n); break;
    case 2: {
      Offs27 so;
      for (int b = 0; b < 27; ++b) so.o[b] = host_offs[b];
      one_row_params<<<g1, kT, 0, s>>>(V, so, X, Y, n);
      break;
    }
    case 3:
      two_adjacent<<<(n / 2 + kT - 1) / kT, kT, 0, s>>>(V, offs, o32, B, X, Y, n);
      break;
    case 4:
      four_adjacent<<<(n / 4 + kT - 1) / kT, kT, 0, s>>>(V, offs, o32, B, X, Y, n);
      break;
    case 5:
      two_apart<<<(n + 2 * kT - 1) / (2 * kT), kT, 0, s>>>(V, offs, o32, B, X, Y, n);
      break;
    case 6: one_row_staged<8><<<g1, kT, 0, s>>>(V, offs, o32, B, X, Y, n); break;
    case 7: one_row_staged<9><<<g1, kT, 0, s>>>(V, offs, o32, B, X, Y, n); break;
    case 8: one_row_staged<16><<<g1, kT, 0, s>>>(V, offs, o32, B, X, Y, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
