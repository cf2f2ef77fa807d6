// Exact re-rank epilogue over the K' survivors of the fused scan.
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_topk` in
// src/repro/kernels/ivf_scan.py (body at :815, pallas_call at :859).  For
// every query it dequantizes the gathered survivor rows (rows * scale),
// computes exact float32 distances, masks locations of -1 to (inf, -1), and
// sorts the K' pairs by (distance, location).
//
// What bounds it on an H100: bytes, Q*K'*D*sizeof(row) plus the [Q, K']
// scales, locations and outputs: 4 MB at Q=64, K'=128, D=128 in float32,
// about 1.3 us at 3.35 TB/s, below the time of one launch.  So what it pays
// for is latency: the first design spent about 18 us on one block per query
// whose warps walked 16 rows each one after another (scalar loads, two
// 5-step shuffle reductions a row) and then sorted the K' keys by a bitonic
// network in shared memory, 28 stages behind a barrier each with a quarter
// of the threads at work.
//
// Design: one block of 512 threads per query, and no barrier before the
// sort.  A row is read by as many lanes as its bytes fill with 16-byte loads
// (G = 32 lanes for D 128 in float32, 16 in bfloat16, 8 in int8; a warp
// holds 32 / G rows at a time), and each lane issues the loads of up to
// kBatch rows, their scales and locations and its slice of the query back
// to back before it computes; each row's dot and norm then reduce over its G
// lanes.  Rows whose bytes or alignment 16-byte loads do not fit are read by
// a warp a row, one value a lane (the scalar path).  The keys are sorted in
// runs of 32 in registers, a bitonic network over the lanes of a warp, and
// the runs are merged by rank: a key's place is its place in its run plus,
// for every other run, the number of keys below it there (5-6 steps of a
// binary search; equal keys, which only masked rows make, go by run), written
// straight to the output.  K' above kRankMax (where the ranks would cost more
// than a sort) falls back to the bitonic sort in shared memory.  The TPU
// kernel's tile of 8 queries per grid step is not needed: a block per query
// already gives the card Q blocks.  Only the order of the sums differs from
// the plain version (its einsum), so the two agree within float32 rounding.
#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBatch = 4;       // rows whose loads a lane issues at once
constexpr int kRankMax = 1024;  // K' merged by rank; above, a bitonic sort

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

// values of T in a 16-byte unit
template <typename T>
constexpr int kPer = 16 / static_cast<int>(sizeof(T));

// the 16 bytes of a unit, widened to float32
template <typename T>
__device__ __forceinline__ void widen_unit(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 255));
  } else {
    widen16<T>(u, f);
  }
}

// sum of q[d] * q[d] over one warp's lanes, the same in every warp
__device__ __forceinline__ float query_norm(const float* __restrict__ q, int D) {
  float v = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) v = fmaf(q[d], q[d], v);
  return warp_sum(v);
}

__device__ __forceinline__ unsigned long long row_key(float qn, float vn,
                                                      float dot, int l) {
  return l != -1 ? make_key(l2_from_parts(qn, vn, dot), l) : EMPTY_KEY;
}

// Keys of the K' rows into keys[0..K), 16-byte loads: G lanes a row
// (a power of two, G >= min(32, units a row)).
template <typename T>
__device__ __forceinline__ void keys_vec(const float* __restrict__ q,
                                         const T* __restrict__ rows,
                                         const float* __restrict__ scales,
                                         const int* __restrict__ loc, int K,
                                         int D, int G,
                                         unsigned long long* keys) {
  constexpr int P = kPer<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane & (G - 1), rsub = lane / G, rpw = 32 / G;
  const int NU = D / P, UJ = (NU + G - 1) / G;  // units a row, a lane
  const int step = nwarps * rpw;                // rows a pass of the block
  const int nI = (K + step - 1) / step;         // passes (uniform)
  float qn = 0.f;
  for (int i0 = 0; i0 < nI; i0 += kBatch) {
    int r[kBatch], lc[kBatch];
    float sc[kBatch], dot[kBatch], vn[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      r[b] = ((i0 + b) * nwarps + warp) * rpw + rsub;  // >= K past the rows
      sc[b] = r[b] < K ? scales[r[b]] : 0.f;
      lc[b] = r[b] < K ? loc[r[b]] : -1;
      dot[b] = 0.f;
      vn[b] = 0.f;
    }
    for (int j = 0; j < UJ; ++j) {
      const int u = sub + j * G;
      uint4 v[kBatch];
      float4 qv[P / 4];
      if (u < NU) {
#pragma unroll
        for (int k = 0; k < P / 4; ++k)
          qv[k] = reinterpret_cast<const float4*>(q + u * P)[k];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (u < NU && r[b] < K)
          v[b] = reinterpret_cast<const uint4*>(rows + static_cast<size_t>(r[b]) * D)[u];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!(u < NU && r[b] < K)) continue;
        float f[P];
        widen_unit<T>(v[b], f);
        const float* qf = reinterpret_cast<const float*>(qv);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const float x = f[e] * sc[b];
          dot[b] = fmaf(qf[e], x, dot[b]);
          vn[b] = fmaf(x, x, vn[b]);
        }
      }
    }
    // after the first rows' loads are in flight: ||q||^2 (L1 hits by now)
    if (i0 == 0) qn = query_norm(q, D);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        dot[b] += __shfl_xor_sync(0xffffffffu, dot[b], o);
        vn[b] += __shfl_xor_sync(0xffffffffu, vn[b], o);
      }
      if (sub == 0 && r[b] < K) keys[r[b]] = row_key(qn, vn[b], dot[b], lc[b]);
    }
  }
}

// The same, a warp a row, one value a lane.
template <typename T>
__device__ __forceinline__ void keys_scalar(const float* __restrict__ q,
                                            const T* __restrict__ rows,
                                            const float* __restrict__ scales,
                                            const int* __restrict__ loc, int K,
                                            int D, unsigned long long* keys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float qn = query_norm(q, D);
  for (int r = warp; r < K; r += nwarps) {
    const T* row = rows + static_cast<size_t>(r) * D;
    const float sc = scales[r];
    float dot = 0.f, vn = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = widen<T>(row[d]) * sc;
      dot = fmaf(q[d], v, dot);
      vn = fmaf(v, v, vn);
    }
    dot = warp_sum(dot);
    vn = warp_sum(vn);
    if (lane == 0) keys[r] = row_key(qn, vn, dot, loc[r]);
  }
}

// Sort keys[0..K) and write them decoded to out_d/out_i [K].  nbuf: K
// rounded up to 32 (K <= kRankMax) or to a power of two.
__device__ __forceinline__ void sort_and_store(unsigned long long* keys, int K,
                                               int nbuf, float* __restrict__ out_d,
                                               int* __restrict__ out_i) {
  const int tid = threadIdx.x;
  if (K > kRankMax) {
    for (int i = K + tid; i < nbuf; i += blockDim.x) keys[i] = EMPTY_KEY;
    __syncthreads();
    bitonic_sort(keys, nbuf);
    for (int i = tid; i < K; i += blockDim.x) store_key(keys[i], &out_d[i], &out_i[i]);
    return;
  }
  const int nruns = nbuf >> 5;
  __syncthreads();
  sort_runs32(keys, K);
  __syncthreads();
  for (int i = tid; i < nbuf; i += blockDim.x) {
    const int a = i >> 5;
    const unsigned long long x = keys[i];
    int rank = i & 31;
    for (int r = 0; r < nruns; ++r)  // equal keys of earlier runs go first
      if (r != a) rank += count_in_run32(keys + r * 32, x, r < a);
    if (rank < K) store_key(x, &out_d[rank], &out_i[rank]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ queries, const T* __restrict__ rows,
              const float* __restrict__ scales, const int* __restrict__ loc,
              int K, int D, int G, int nbuf, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  extern __shared__ unsigned long long keys[];  // [nbuf] >= K
  const int qi = blockIdx.x;
  const size_t at = static_cast<size_t>(qi) * K;
  const float* q = queries + static_cast<size_t>(qi) * D;
  if constexpr (kVec)
    keys_vec<T>(q, rows + at * D, scales + at, loc + at, K, D, G, keys);
  else
    keys_scalar<T>(q, rows + at * D, scales + at, loc + at, K, D, keys);
  sort_and_store(keys, K, nbuf, out_d + at, out_i + at);
}

template <typename T>
int launch(const float* queries, const void* rows, const float* scales,
           const int* loc, int Q, int K, int D, int vec, float* out_d,
           int* out_i, void* stream) {
  const int nbuf = K <= kRankMax ? (K + 31) & ~31 : next_pow2(K);
  const size_t smem = static_cast<size_t>(nbuf) * sizeof(unsigned long long);
  const int nu = D / kPer<T>;
  const int G = nu >= 32 ? 32 : next_pow2(nu);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec ? allow_smem(rerank_kernel<T, true>, smem)
                        : allow_smem(rerank_kernel<T, false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    rerank_kernel<T, true><<<Q, kThreads, smem, st>>>(
        queries, static_cast<const T*>(rows), scales, loc, K, D, G, nbuf, out_d, out_i);
  else
    rerank_kernel<T, false><<<Q, kThreads, smem, st>>>(
        queries, static_cast<const T*>(rows), scales, loc, K, D, G, nbuf, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// queries [Q, D] f32; rows [Q, K, D] f32 | bf16 | i8; scales [Q, K] f32;
// loc [Q, K] i32 (-1 = invalid) -> out_d [Q, K] f32, out_i [Q, K] i32
// ascending by (distance, location).  vec != 0: a row's D values fill whole
// 16-byte units and queries and rows are 16-byte aligned.
extern "C" int rerank_topk_f32(const float* queries, const void* rows,
                               const float* scales, const int* loc, int Q,
                               int K, int D, int vec, float* out_d, int* out_i,
                               void* stream) {
  return launch<float>(queries, rows, scales, loc, Q, K, D, vec, out_d, out_i,
                       stream);
}

extern "C" int rerank_topk_bf16(const float* queries, const void* rows,
                                const float* scales, const int* loc, int Q,
                                int K, int D, int vec, float* out_d, int* out_i,
                                void* stream) {
  return launch<__nv_bfloat16>(queries, rows, scales, loc, Q, K, D, vec, out_d,
                               out_i, stream);
}

extern "C" int rerank_topk_i8(const float* queries, const void* rows,
                              const float* scales, const int* loc, int Q, int K,
                              int D, int vec, float* out_d, int* out_i,
                              void* stream) {
  return launch<int8_t>(queries, rows, scales, loc, Q, K, D, vec, out_d, out_i,
                        stream);
}

// An empty kernel on the re-rank's grid (Q blocks of 512 threads): the
// floor that a launch of that shape costs on the card, for timing beside it.
extern "C" int rerank_topk_empty(int Q, void* stream) {
  empty_kernel<<<Q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
