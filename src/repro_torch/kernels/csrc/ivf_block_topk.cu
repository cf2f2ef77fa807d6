// Fused IVF block scan with a streaming top-K' (the search's hot loop).
//
// Replaces the TPU kernel `_topk_kernel` / `ivf_block_topk` in
// src/repro/kernels/ivf_scan.py (pallas_call at :448).  For every query it
// scores the rows of the candidate blocks whose owning cluster is in the
// query's probe list, masks empty slots (id -1) and tombstones (live == 0),
// and returns the K' nearest as ascending (distance, packed location
// block*T + offset).  Payloads are float32 or bfloat16; for bf16 the query is
// rounded to bf16, the products are taken and summed in float32, and ||v||^2
// comes from the bf16 value widened to float32, as in the TPU kernel.
//
// What bounds it on an H100: bytes.  The function must read every candidate
// block once, C*T*D*sizeof(payload): with about 2000 blocks of 1024 x 128
// float32 that is about 1 GB, 0.3 ms at 3.35 TB/s, against a few hundred
// MFLOP of dot products.
//
// Design, split over the candidates as flash-decoding splits a sequence:
// * Pass 1, grid (query, chunk of candidates).  The TPU kernel walks the
//   candidates in order and carries the top-K' accumulator in VMEM from one
//   grid step to the next; blocks on Hopper run in no order, so instead each
//   block owns one query and one chunk.  It tests membership first (owner
//   against the query's probe list in shared memory) and skips the blocks
//   its query does not probe: the TPU kernel computes the full [Q_t, T]
//   product for every block and masks it afterwards, though a block is
//   probed by only about Q*NP/C (about one) query of a batch.  A member
//   block is scored one warp per row (coalesced 128-byte reads along D), and
//   its T keys are merged into the running top-K' kept in shared memory by a
//   bitonic sort of the K' + T keys.  The chunk's K' best go to a partial
//   buffer [Q, S, K'].
// * Pass 2, one block per query, sorts the S*K' partial keys and writes the
//   first K'.
// A member block is read once per query that probes it, not once per batch;
// that, the sort per member block, and blocks of the grid that find no member
// at all are what keep this first design above its bound.
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

// the query as the payload type sees it: rounded to bf16 for bf16 blocks
template <typename T>
__device__ __forceinline__ float round_query(float q);
template <>
__device__ __forceinline__ float round_query<float>(float q) {
  return q;
}
template <>
__device__ __forceinline__ float round_query<__nv_bfloat16>(float q) {
  return __bfloat162float(__float2bfloat16(q));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_pass1(const float* __restrict__ queries, const T* __restrict__ pool,
                 int T_m, int D, const int* __restrict__ block_ids,
                 const int* __restrict__ owners, int C, int chunk,
                 const int* __restrict__ pool_ids,
                 const uint8_t* __restrict__ pool_live,
                 const int* __restrict__ probe, int NP, int K, int nbuf,
                 unsigned long long* __restrict__ partial) {
  extern __shared__ unsigned long long buf[];  // [nbuf] keys, nbuf >= K + T_m
  float* qs = reinterpret_cast<float*>(buf + nbuf);  // [D] rounded query
  int* probes = reinterpret_cast<int*>(qs + D);      // [NP]
  __shared__ int member[kThreads];
  __shared__ float qn_s;

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = s * chunk;
  const int c1 = min(C, c0 + chunk);
  const float* q = queries + static_cast<size_t>(qi) * D;

  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = round_query<T>(q[d]);
  for (int p = threadIdx.x; p < NP; p += blockDim.x)
    probes[p] = probe[static_cast<size_t>(qi) * NP + p];
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x) buf[i] = EMPTY_KEY;
  if (warp == 0) {  // ||q||^2 of the float32 query, as the reference takes it
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v = fmaf(q[d], q[d], v);
    v = warp_sum(v);
    if (lane == 0) qn_s = v;
  }
  __syncthreads();
  const float qn = qn_s;

  for (int g = c0; g < c1; g += blockDim.x) {
    const int c = g + threadIdx.x;
    int m = 0;
    if (c < c1) {
      const int own = owners[c];
      if (own >= 0)
        for (int p = 0; p < NP; ++p) m |= probes[p] == own;
    }
    member[threadIdx.x] = m;
    __syncthreads();
    const int gn = min(static_cast<int>(blockDim.x), c1 - g);
    for (int j = 0; j < gn; ++j) {
      if (!member[j]) continue;  // uniform over the block
      const int blk = max(block_ids[g + j], 0);
      const T* rows = pool + static_cast<size_t>(blk) * T_m * D;
      for (int t = warp; t < T_m; t += nwarps) {
        const T* row = rows + static_cast<size_t>(t) * D;
        float dot = 0.f, vn = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float v = widen<T>(row[d]);
          dot = fmaf(qs[d], v, dot);
          vn = fmaf(v, v, vn);
        }
        dot = warp_sum(dot);
        vn = warp_sum(vn);
        if (lane == 0) {
          const int slot = blk * T_m + t;
          const bool ok = pool_ids[slot] != -1 && pool_live[slot] != 0;
          buf[K + t] = ok ? make_key(l2_from_parts(qn, vn, dot), slot) : EMPTY_KEY;
        }
      }
      // keys past K + T_m are whatever the last sort left there; clear them
      for (int i = K + T_m + threadIdx.x; i < nbuf; i += blockDim.x)
        buf[i] = EMPTY_KEY;
      __syncthreads();
      bitonic_sort(buf, nbuf);
    }
    __syncthreads();  // member[] is rewritten by the next group
  }

  unsigned long long* out = partial + (static_cast<size_t>(qi) * S + s) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) out[i] = buf[i];
}

__global__ void __launch_bounds__(kThreads)
block_topk_merge(const unsigned long long* __restrict__ partial, int S, int K,
                 int nbuf, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned long long buf[];  // [nbuf] >= S*K
  const int qi = blockIdx.x;
  const unsigned long long* in = partial + static_cast<size_t>(qi) * S * K;
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x)
    buf[i] = i < S * K ? in[i] : EMPTY_KEY;
  __syncthreads();
  bitonic_sort(buf, nbuf);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    store_key(buf[i], &out_d[static_cast<size_t>(qi) * K + i],
              &out_i[static_cast<size_t>(qi) * K + i]);
}

template <typename T>
int launch(const float* queries, const void* pool, int T_m, int D,
           const int* block_ids, const int* owners, int C, int chunk, int S,
           const int* pool_ids, const uint8_t* pool_live, const int* probe,
           int Q, int NP, int K, unsigned long long* partial, float* out_d,
           int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbuf1 = next_pow2(K + T_m);
  const size_t smem1 = nbuf1 * sizeof(unsigned long long) +
                       static_cast<size_t>(D + NP) * sizeof(float);
  cudaError_t err = allow_smem(block_topk_pass1<T>, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_topk_pass1<T><<<dim3(Q, S), kThreads, smem1, st>>>(
      queries, static_cast<const T*>(pool), T_m, D, block_ids, owners, C, chunk,
      pool_ids, pool_live, probe, NP, K, nbuf1, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nbuf2 = next_pow2(S * K);
  const size_t smem2 = nbuf2 * sizeof(unsigned long long);
  err = allow_smem(block_topk_merge, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_topk_merge<<<Q, kThreads, smem2, st>>>(partial, S, K, nbuf2, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [Q, D] f32; pool [P, T_m, D] f32 | bf16; block_ids, owners [C] i32;
// pool_ids [P, T_m] i32; pool_live [P, T_m] u8; probe [Q, NP] i32;
// partial [Q, S, K] u64 scratch; -> out_d [Q, K] f32, out_i [Q, K] i32.
// The candidates are cut into S chunks of `chunk` (S * chunk >= C > 0).
extern "C" int ivf_block_topk_f32(const float* queries, const void* pool,
                                  int T_m, int D, const int* block_ids,
                                  const int* owners, int C, int chunk, int S,
                                  const int* pool_ids, const uint8_t* pool_live,
                                  const int* probe, int Q, int NP, int K,
                                  unsigned long long* partial, float* out_d,
                                  int* out_i, void* stream) {
  return launch<float>(queries, pool, T_m, D, block_ids, owners, C, chunk, S,
                       pool_ids, pool_live, probe, Q, NP, K, partial, out_d,
                       out_i, stream);
}

extern "C" int ivf_block_topk_bf16(const float* queries, const void* pool,
                                   int T_m, int D, const int* block_ids,
                                   const int* owners, int C, int chunk, int S,
                                   const int* pool_ids, const uint8_t* pool_live,
                                   const int* probe, int Q, int NP, int K,
                                   unsigned long long* partial, float* out_d,
                                   int* out_i, void* stream) {
  return launch<__nv_bfloat16>(queries, pool, T_m, D, block_ids, owners, C,
                               chunk, S, pool_ids, pool_live, probe, Q, NP, K,
                               partial, out_d, out_i, stream);
}
