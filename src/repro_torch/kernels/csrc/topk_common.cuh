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
#include <cuda_bf16.h>
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

// Pass 2 for partials that pass 1 wrote sorted ([Q, S, K], each run of K
// ascending): one block per query places every key by its rank in the
// union, its position in its own run plus the number of smaller keys in
// each other run (a binary search), and writes the keys of rank < K
// decoded.  Non-empty keys are unique (distance, location) pairs, so the
// ranks are distinct; output places no key reaches stay EMPTY_KEY.  One
// pass over S*K keys with one barrier, where merge_partials sorts
// next_pow2(S*K) keys in log^2 stages.
__global__ void __launch_bounds__(256)
merge_sorted_partials(const unsigned long long* __restrict__ partial, int S,
                      int K, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned long long runs[];  // [S*K] then [K] output
  unsigned long long* top = runs + static_cast<size_t>(S) * K;
  const int qi = blockIdx.x;
  const unsigned long long* in = partial + static_cast<size_t>(qi) * S * K;
  for (int i = threadIdx.x; i < S * K; i += blockDim.x) runs[i] = in[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) top[i] = EMPTY_KEY;
  __syncthreads();
  for (int i = threadIdx.x; i < S * K; i += blockDim.x) {
    const unsigned long long x = runs[i];
    if (x == EMPTY_KEY) continue;
    const int a = i / K;
    int rank = i - a * K;
    for (int r = 0; r < S && rank < K; ++r) {
      if (r == a) continue;
      const unsigned long long* run = runs + static_cast<size_t>(r) * K;
      int lo = 0, hi = K;  // keys of run r below x
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run[mid] < x) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < K) top[rank] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    store_key(top[i], &out_d[static_cast<size_t>(qi) * K + i],
              &out_i[static_cast<size_t>(qi) * K + i]);
}

inline int launch_merge_sorted(const unsigned long long* partial, int Q, int S,
                               int K, float* out_d, int* out_i, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(S) + 1) * K * sizeof(unsigned long long);
  const cudaError_t err = allow_smem(merge_sorted_partials, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sorted_partials<<<Q, 256, smem, st>>>(partial, S, K, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, bypassing L1), grouped by commit and awaited by group count.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// the same, filling the 16 bytes with zeros instead when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0..3) of this thread's groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// 16 bytes of float32 or bfloat16 values, widened to float32
template <typename T>
__device__ __forceinline__ void widen16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
