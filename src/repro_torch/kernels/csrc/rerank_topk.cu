// Exact re-rank epilogue over the K' survivors of the fused scan.
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_topk` in
// src/repro/kernels/ivf_scan.py (pallas_call at :859).  For every query it
// dequantizes the gathered survivor rows (rows * scale), computes exact
// float32 distances, masks locations of -1 to (inf, -1), and sorts the K'
// pairs by (distance, location).
//
// What bounds it on an H100: bytes, Q*K'*D*sizeof(row) plus the [Q, K']
// scales, locations and outputs: 4 MB at Q=64, K'=128, D=128 in float32,
// about 1.3 us at 3.35 TB/s, less than one launch.
//
// Design: one block per query.  One warp per row reads it in coalesced
// 128-byte pieces along D and reduces ||v||^2 and q.v with shuffles; the K'
// packed (distance, location) keys are sorted by a bitonic network in shared
// memory (1 KB at K' = 128).  The TPU kernel's tile of 8 queries per grid
// step is not needed: a block per query already gives the card Q blocks.
#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ queries, const T* __restrict__ rows,
              const float* __restrict__ scales, const int* __restrict__ loc,
              int K, int D, int nbuf, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  extern __shared__ unsigned long long buf[];        // [nbuf] >= K keys
  float* qs = reinterpret_cast<float*>(buf + nbuf);  // [D]
  __shared__ float qn_s;

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int d = threadIdx.x; d < D; d += blockDim.x)
    qs[d] = queries[static_cast<size_t>(qi) * D + d];
  for (int i = K + threadIdx.x; i < nbuf; i += blockDim.x) buf[i] = EMPTY_KEY;
  __syncthreads();
  if (warp == 0) {
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v = fmaf(qs[d], qs[d], v);
    v = warp_sum(v);
    if (lane == 0) qn_s = v;
  }
  __syncthreads();
  const float qn = qn_s;

  for (int r = warp; r < K; r += nwarps) {
    const size_t at = static_cast<size_t>(qi) * K + r;
    const T* row = rows + at * D;
    const float sc = scales[at];
    float dot = 0.f, vn = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = widen<T>(row[d]) * sc;
      dot = fmaf(qs[d], v, dot);
      vn = fmaf(v, v, vn);
    }
    dot = warp_sum(dot);
    vn = warp_sum(vn);
    if (lane == 0) {
      const int l = loc[at];
      buf[r] = l != -1 ? make_key(l2_from_parts(qn, vn, dot), l) : EMPTY_KEY;
    }
  }
  __syncthreads();
  bitonic_sort(buf, nbuf);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    store_key(buf[i], &out_d[static_cast<size_t>(qi) * K + i],
              &out_i[static_cast<size_t>(qi) * K + i]);
}

template <typename T>
int launch(const float* queries, const void* rows, const float* scales,
           const int* loc, int Q, int K, int D, float* out_d, int* out_i,
           void* stream) {
  const int nbuf = next_pow2(K);
  const size_t smem =
      nbuf * sizeof(unsigned long long) + static_cast<size_t>(D) * sizeof(float);
  cudaError_t err = allow_smem(rerank_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_kernel<T><<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, static_cast<const T*>(rows), scales, loc, K, D, nbuf, out_d,
      out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [Q, D] f32; rows [Q, K, D] f32 | bf16 | i8; scales [Q, K] f32;
// loc [Q, K] i32 (-1 = invalid) -> out_d [Q, K] f32, out_i [Q, K] i32
// ascending by (distance, location).
extern "C" int rerank_topk_f32(const float* queries, const void* rows,
                               const float* scales, const int* loc, int Q,
                               int K, int D, float* out_d, int* out_i,
                               void* stream) {
  return launch<float>(queries, rows, scales, loc, Q, K, D, out_d, out_i, stream);
}

extern "C" int rerank_topk_bf16(const float* queries, const void* rows,
                                const float* scales, const int* loc, int Q,
                                int K, int D, float* out_d, int* out_i,
                                void* stream) {
  return launch<__nv_bfloat16>(queries, rows, scales, loc, Q, K, D, out_d,
                               out_i, stream);
}

extern "C" int rerank_topk_i8(const float* queries, const void* rows,
                              const float* scales, const int* loc, int Q, int K,
                              int D, float* out_d, int* out_i, void* stream) {
  return launch<int8_t>(queries, rows, scales, loc, Q, K, D, out_d, out_i,
                        stream);
}
