// Streaming coarse probe: the top-nprobe nearest centroids of every query.
//
// Replaces the TPU kernel `_coarse_kernel` / `coarse_topk` in
// src/repro/kernels/ivf_scan.py (body at :153, pallas_call at :234), which
// streams centroid tiles through VMEM and merges them into a per-query
// top-nprobe accumulator, so it takes any number of centroids N.
//
// What bounds it on an H100: at SIFT1M's shapes (Q = 64 queries, N = 4000
// centroids, D = 128) the function reads 2 MB of centroids, about 0.6 us at
// 3.35 TB/s, and does 65 MFLOP, about 1 us at 67 TFLOP/s on the float32
// cores; at the DSSM deployment's (N = 160,000, D = 64) 41 MB, about 12 us,
// and 1.3 GFLOP, about 20 us: operations.
//
// Design, split over the centroids as ivf_block_topk.cu splits candidates:
// * Pass 1, grid (tile of kQT queries, chunk of centroids).  A block stages
//   its queries once and then tiles of TC centroids in shared memory (rows
//   padded by one float, so the lanes of a warp, one centroid each, read
//   distinct banks), and every staged centroid serves all kQT queries: the
//   centroids are read from memory once per query tile, not once per query.
//   Each (query, centroid) distance is l2_from_parts(||q||^2, ||c||^2, q.c)
//   packed with the centroid id into one 64-bit key, so ties go to the lower
//   id as the reference's top_k gives them.  Every query owns a segment of
//   shared memory: its sorted top-NP, then an area of CB candidates.  A key
//   enters the area only if it beats the query's current NP-th best (the
//   threshold), and the segment is sorted only when an area could overflow
//   on the next tile, and once at the end: after the first sort the
//   threshold lets few keys through, so a chunk of some 40 tiles needs a
//   handful of sorts, not one per tile (the first design of this repair
//   sorted every tile and ran at 1.69 ms at N = 160,000).  The chunk's NP
//   best per query go to a partial buffer [Q, S, NP].
// * Pass 2 (merge_partials in topk_common.cuh) sorts each query's S*NP keys
//   and writes the first NP decoded.
// Shared memory holds kQT segments of next_pow2(NP + CB) keys and one tile
// of centroids, whatever N is; pass 2 sorts S*NP keys of a query in shared
// memory, which bounds NP (the wrapper checks both).  Segments, TC and CB
// are powers of two, so the hot loops index with shifts and masks.
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 8;  // queries per block: one warp computes each ||q||^2

// Ascending bitonic sort of every segment of `seg` keys (a power of two);
// then each query's threshold is its NP-th best, its area is emptied.
__device__ __forceinline__ void sort_segments(unsigned long long* keys, int seg,
                                              int NP, int* cnt,
                                              unsigned long long* thr) {
  const int n = kQT * seg;
  for (int k = 2; k <= seg; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          const bool up = (i & (seg - 1) & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if ((i & (seg - 1)) >= NP) keys[i] = EMPTY_KEY;
  if (threadIdx.x < kQT) {
    thr[threadIdx.x] = keys[threadIdx.x * seg + NP - 1];
    cnt[threadIdx.x] = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
coarse_pass1(const float* __restrict__ queries, const float* __restrict__ cents,
             int Q, int N, int D, int NP, int TC, int CB, int chunk, int seg,
             unsigned long long* __restrict__ partial) {
  extern __shared__ unsigned long long keys[];  // [kQT][seg], seg >= NP + CB
  float* qs = reinterpret_cast<float*>(keys + kQT * seg);  // [kQT][D]
  float* cs = qs + kQT * D;                                // [TC][D + 1]
  float* cn = cs + TC * (D + 1);                           // [TC]
  __shared__ float qn[kQT];
  __shared__ int cnt[kQT];                 // candidates in each query's area
  __shared__ unsigned long long thr[kQT];  // each query's NP-th best so far

  const int q0 = blockIdx.x * kQT, s = blockIdx.y, S = gridDim.y;
  const int n0 = s * chunk, n1 = min(N, n0 + chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = min(kQT, Q - q0);
  const int dp = D + 1;
  const int tc_shift = __ffs(TC) - 1;

  for (int i = threadIdx.x; i < kQT * D; i += blockDim.x) {
    const int qi = i / D;
    qs[i] = qi < nq ? queries[static_cast<size_t>(q0) * D + i] : 0.f;
  }
  for (int i = threadIdx.x; i < kQT * seg; i += blockDim.x) keys[i] = EMPTY_KEY;
  if (threadIdx.x < kQT) {
    cnt[threadIdx.x] = 0;
    thr[threadIdx.x] = EMPTY_KEY;
  }
  __syncthreads();
  if (warp < kQT) {
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v = fmaf(qs[warp * D + d], qs[warp * D + d], v);
    v = warp_sum(v);
    if (lane == 0) qn[warp] = v;
  }

  for (int c0 = n0; c0 < n1; c0 += TC) {
    const int tc = min(TC, n1 - c0);
    const float* tile = cents + static_cast<size_t>(c0) * D;
    for (int i = threadIdx.x; i < tc * D; i += blockDim.x)
      cs[(i / D) * dp + i % D] = tile[i];  // coalesced along the tile
    __syncthreads();
    // an area that could overflow on this tile is merged first (uniform:
    // every thread reads the same counts after the barrier)
    bool full = false;
    for (int qi = 0; qi < kQT; ++qi) full |= cnt[qi] > CB - TC;
    if (full) sort_segments(keys, seg, NP, cnt, thr);
    for (int c = threadIdx.x; c < tc; c += blockDim.x) {
      float v = 0.f;
      for (int d = 0; d < D; ++d) v = fmaf(cs[c * dp + d], cs[c * dp + d], v);
      cn[c] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (kQT << tc_shift); i += blockDim.x) {
      const int qi = i >> tc_shift, c = i & (TC - 1);
      if (qi < nq && c < tc) {
        const float* qv = qs + qi * D;
        const float* cv = cs + c * dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qv[d], cv[d], dot);
        const unsigned long long key =
            make_key(l2_from_parts(qn[qi], cn[c], dot), c0 + c);
        if (key < thr[qi]) keys[qi * seg + NP + atomicAdd(&cnt[qi], 1)] = key;
      }
    }
    __syncthreads();  // cs, cn and the areas are rewritten by the next tile
  }
  sort_segments(keys, seg, NP, cnt, thr);

  for (int i = threadIdx.x; i < nq * NP; i += blockDim.x) {
    const int qi = i / NP, r = i % NP;
    partial[(static_cast<size_t>(q0 + qi) * S + s) * NP + r] = keys[qi * seg + r];
  }
}

}  // namespace

// queries [Q, D] f32, cents [N, D] f32 -> out_i [Q, NP] i32, out_d [Q, NP]
// f32, both ascending by (distance, centroid id).  Requires 0 < NP <= N.
// The centroids are cut into S chunks of `chunk` (S * chunk >= N), each
// scored in tiles of TC; every query keeps an area of CB candidates
// (CB >= TC, both powers of two); partial [Q, S, NP] u64 is scratch.
extern "C" int coarse_topk_f32(const float* queries, const float* cents, int Q,
                               int N, int D, int NP, int TC, int CB, int chunk,
                               int S, unsigned long long* partial, int* out_i,
                               float* out_d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int seg = next_pow2(NP + CB);
  const size_t smem = static_cast<size_t>(kQT) * seg * sizeof(unsigned long long) +
                      (static_cast<size_t>(kQT) * D +
                       static_cast<size_t>(TC) * (D + 1) + TC) * sizeof(float);
  cudaError_t err = allow_smem(coarse_pass1, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + kQT - 1) / kQT, S);
  coarse_pass1<<<grid, kThreads, smem, st>>>(queries, cents, Q, N, D, NP, TC,
                                             CB, chunk, seg, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, Q, S, NP, out_d, out_i, st);
}
