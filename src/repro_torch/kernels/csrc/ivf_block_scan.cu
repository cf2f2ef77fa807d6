// IVF block scan, scores only: out[c][q][t] = ||q||^2 + ||v||^2 - 2 q.v for
// every query q and every row t of candidate block block_ids[c].
//
// Replaces the TPU kernel `_scan_kernel` / `ivf_block_scan` in
// src/repro/kernels/ivf_scan.py (body at :91, pallas_call at :130), which
// serves the `union_pallas` comparison path: the caller masks the [C, Q, T]
// scores and selects k over C*T.  Hole ids (-1) are scored against block 0,
// as the TPU kernel's clamped index map does.  Payloads are float32 or
// bfloat16; for bf16 the query is rounded to bf16 and the products are
// taken and summed in float32 (a product of two bf16 values is exact in
// float32), ||v||^2 comes from the bf16 value widened, ||q||^2 from the
// float32 query, as in the TPU kernel.
//
// What bounds it on an H100: operations.  2*C*Q*T*D float32 FMA operations
// (at SIFT1M's union shapes, C = 1569, Q = 64, T = 1024, D = 128: 26.3 GFLOP,
// 0.39 ms at 67 TFLOP/s) against C*T*D*sizeof(payload) bytes of blocks read
// and C*Q*T*4 bytes of scores written (1.23 GB, 0.37 ms at 3.35 TB/s).  The
// dot is the TPU kernel's own MXU product, so it is computed here in full
// float32, not by cuBLAS and not in TF32.
//
// Design: a register-tiled product, one block per (candidate, tile of 64
// rows, tile of 64 queries).  The block stages chunks of 32 dimensions of
// its query tile and of its row tile in shared memory (transposed, so a
// thread reads 4 queries and 4 rows as two float4 loads), and each of its
// 256 threads accumulates a 4 x 4 tile of dots with float32 FMAs.  The
// row norms are summed from the staged chunks, the query norms from the
// float32 queries once per block.  The epilogue rounds as the reference's
// float32 expression does, (qn + vn) - 2*dot with no FMA contraction, and
// each thread writes 4 rows of 4 consecutive scores.
#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTileQ = 64;
constexpr int kTileT = 64;
constexpr int kChunk = 32;          // dimensions staged per step
constexpr int kStride = kTileT + 4;  // keeps float4 rows aligned

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
block_scan(const float* __restrict__ queries, const T* __restrict__ pool,
           int Q, int T_m, int D, const int* __restrict__ block_ids,
           int n_ttiles, float* __restrict__ out) {
  __shared__ __align__(16) float qs[kChunk][kStride];  // [d][query]
  __shared__ __align__(16) float vs[kChunk][kStride];  // [d][row]
  __shared__ float qn_s[kTileQ];
  __shared__ float vn_s[kTileT];

  const int c = blockIdx.x / n_ttiles;
  const int t0 = (blockIdx.x % n_ttiles) * kTileT;
  const int q0 = blockIdx.y * kTileQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int blk = max(block_ids[c], 0);
  const T* rows = pool + static_cast<size_t>(blk) * T_m * D;

  if (tid < kTileQ) {  // ||q||^2 of the float32 query
    float s = 0.f;
    if (q0 + tid < Q) {
      const float* qrow = queries + static_cast<size_t>(q0 + tid) * D;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], qrow[d], s);
    }
    qn_s[tid] = s;
  }

  float acc[4][4] = {};
  float vn = 0.f;  // ||v||^2 of row t0 + tid, for tid < kTileT
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    // stage [64 x 32] of queries and rows: consecutive threads read
    // consecutive dimensions of one query / row
    for (int i = tid; i < kTileQ * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      const int qi = q0 + r, d = d0 + k;
      qs[k][r] = (qi < Q && d < D)
                     ? round_query<T>(queries[static_cast<size_t>(qi) * D + d])
                     : 0.f;
      const int ti = t0 + r;
      vs[k][r] = (ti < T_m && d < D)
                     ? widen<T>(rows[static_cast<size_t>(ti) * D + d])
                     : 0.f;
    }
    __syncthreads();
    if (tid < kTileT)
      for (int k = 0; k < kChunk; ++k) vn = fmaf(vs[k][tid], vs[k][tid], vn);
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&vs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTileT) vn_s[tid] = vn;
  __syncthreads();

  const int tb = t0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Q) continue;
    const float qn = qn_s[ty * 4 + i];
    float* dst = out + (static_cast<size_t>(c) * Q + qi) * T_m;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = l2_from_parts(qn, vn_s[tx * 4 + j], acc[i][j]);
    if ((T_m & 3) == 0 && tb + 3 < T_m) {
      *reinterpret_cast<float4*>(dst + tb) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tb + j < T_m) dst[tb + j] = r[j];
    }
  }
}

template <typename T>
int launch(const float* queries, const T* pool, int Q, int T_m, int D,
           const int* block_ids, int C, float* out, void* stream) {
  const int n_ttiles = (T_m + kTileT - 1) / kTileT;
  const dim3 grid(C * n_ttiles, (Q + kTileQ - 1) / kTileQ);
  block_scan<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, pool, Q, T_m, D, block_ids, n_ttiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [Q, D] f32; pool [P, T, D] f32 | bf16; block_ids [C] i32 (-1 reads
// block 0) -> out [C, Q, T] f32.  C, Q > 0; C * ceil(T / 64) < 2^31 and
// ceil(Q / 64) <= 65535 (the grid's extents).
extern "C" int ivf_block_scan_f32(const float* queries, const float* pool,
                                  int Q, int T_m, int D, const int* block_ids,
                                  int C, float* out, void* stream) {
  return launch<float>(queries, pool, Q, T_m, D, block_ids, C, out, stream);
}

extern "C" int ivf_block_scan_bf16(const float* queries, const void* pool,
                                   int Q, int T_m, int D, const int* block_ids,
                                   int C, float* out, void* stream) {
  return launch<__nv_bfloat16>(queries,
                               static_cast<const __nv_bfloat16*>(pool), Q, T_m,
                               D, block_ids, C, out, stream);
}
