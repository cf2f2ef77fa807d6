// Shared pieces of the port's top-k kernels.
//
// Every kernel here selects by the two-key order (distance asc, id asc).
// Both keys are packed into one 64-bit integer whose unsigned order is that
// lexicographic order: the high word holds the float's bits mapped to an
// order-preserving unsigned integer, the low word the non-negative id.  A
// selection is then a plain integer min or sort, and ties fall to the lower
// id without a second comparison.  EMPTY_KEY (all ones) stands for a masked
// slot and decodes to (inf, -1).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr unsigned long long EMPTY_KEY = ~0ull;

__device__ __forceinline__ uint32_t ord_f32(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord_f32(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long make_key(float d, int id) {
  return (static_cast<unsigned long long>(ord_f32(d)) << 32) |
         static_cast<uint32_t>(id);
}

__device__ __forceinline__ void store_key(unsigned long long k, float* d,
                                          int* id) {
  if (k == EMPTY_KEY) {
    *d = __int_as_float(0x7f800000);  // +inf
    *id = -1;
  } else {
    *d = unord_f32(static_cast<uint32_t>(k >> 32));
    *id = static_cast<int>(static_cast<uint32_t>(k));
  }
}

// ||q||^2 + ||v||^2 - 2 q.v, rounded step by step as the reference's
// float32 expression is (no contraction into an FMA).
__device__ __forceinline__ float l2_from_parts(float qn, float vn, float dot) {
  return __fsub_rn(__fadd_rn(qn, vn), __fmul_rn(2.0f, dot));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// Ascending bitonic sort of n keys in shared memory, n a power of two.
// Every thread of the block calls it, after the keys are in place and
// visible (a __syncthreads() before the call); it returns synchronized.
__device__ __forceinline__ void bitonic_sort(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s[i], b = s[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Pass 2 of the split top-K' scans: one block per query sorts the S*K
// partial keys of pass 1 ([Q, S, K]) and writes the first K decoded.
__global__ void __launch_bounds__(256)
merge_partials(const unsigned long long* __restrict__ partial, int S, int K,
               int nbuf, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned long long keys[];  // [nbuf] >= S*K
  const int qi = blockIdx.x;
  const unsigned long long* in = partial + static_cast<size_t>(qi) * S * K;
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x)
    keys[i] = i < S * K ? in[i] : EMPTY_KEY;
  __syncthreads();
  bitonic_sort(keys, nbuf);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    store_key(keys[i], &out_d[static_cast<size_t>(qi) * K + i],
              &out_i[static_cast<size_t>(qi) * K + i]);
}

inline int launch_merge(const unsigned long long* partial, int Q, int S, int K,
                        float* out_d, int* out_i, cudaStream_t st) {
  const int nbuf = next_pow2(S * K);
  const size_t smem = nbuf * sizeof(unsigned long long);
  const cudaError_t err = allow_smem(merge_partials, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_partials<<<Q, 256, smem, st>>>(partial, S, K, nbuf, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
