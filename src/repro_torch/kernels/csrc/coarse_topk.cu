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
// and 1.3 GFLOP, about 20 us: operations.  The float32 contract bars TF32.
//
// Design, split over the centroids:
// * Pass 1, grid (tile of QT <= 64 queries, chunk of centroids).  A block
//   walks its chunk in tiles of 128 centroids, and each tile in slices of 32
//   dims: every step stages the slice of the tile's centroids and of the
//   block's queries in shared memory by cp.async (rows padded to 36 floats,
//   16-byte aligned, so the lanes of a quarter warp read distinct banks),
//   two steps in flight, so the next slice loads while this one is used.
//   Each thread holds a register micro-tile of 2 queries x 8 centroids and
//   adds each dim's products with one fmaf, d = 0..D-1 in order per pair,
//   so every distance rounds as a plain loop of fmaf over d gives it; every
//   staged value serves 2 or 8 products (one thread a pair would load two
//   values a product), and the centroids are read once per query tile
//   (QT = 64 holds a search batch; a block of 512 threads).  ||c||^2 is summed in the same loop
//   from the same staged values, d in order; ||q||^2 from the first tile's
//   slices, lane l over dims l, l + 32, ... then a butterfly (warp_sum).
//   Each (query, centroid) distance is l2_from_parts(||q||^2, ||c||^2, q.c)
//   packed with the centroid id into one 64-bit key, so ties go to the
//   lower id as the reference's top_k gives them.
// * Selection, by warps: a warp's lanes hold every candidate of 4 queries
//   (lanes 0-15 two, lanes 16-31 two more), so each warp selects for its
//   own queries without a block barrier; with 2 queries a thread rather
//   than 4, twice the warps share that latency-bound work.  Every query owns a segment of seg
//   keys in shared memory: its sorted top-NP, then an area of candidates.
//   A key enters the area only below the query's threshold, which a
//   chunk's first tile sets at the largest of the 16 lanes' m-th smallest
//   keys (m = ceil(NP / 16): 16m of the tile's own keys are at or below
//   it), and each selection at the NP-th best.  A key's place in the area
//   comes from a warp ballot, and a warp skips a key slot that no lane's
//   key enters.  A key that finds the area full stays in a mask: the warp
//   reduces its segments that hold new keys to their sorted top-NP
//   (warp_select: in registers for NP <= 32), and the keys not yet placed
//   try again.  So a segment is reduced only when its area overflows, and
//   once at the end; sorting all 64 segments of a block together, at block
//   barriers, took longer than the products.  The chunk's sorted NP best
//   per query go to a partial buffer [Q, S, NP].
// * Pass 2 (merge_sorted_partials in topk_common.cuh) gathers the keys of
//   each query's S sorted runs that can be among its NP best and sorts
//   them.
// Shared memory holds QT segments and two steps of staged slices, whatever
// N and D are; pass 2 holds (S + 1) * NP keys of a query, which bounds NP
// (the wrapper's planner, ivf_scan.split_centroids, checks both).
#include "topk_common.cuh"

namespace {

constexpr int kTC = 128;       // centroids a tile
constexpr int kDK = 32;        // dims a slice (a step)
constexpr int kRow = kDK + 4;  // staged row stride, floats
constexpr int kQR = 2;         // queries of a thread's micro-tile
constexpr int kCR = 8;         // centroids of a thread's micro-tile
constexpr int kCG = kTC / kCR;  // centroid groups: 16 threads span a tile
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// Ascending bitonic sort of `seg` keys (a power of two) by one warp;
// __syncwarp() orders the stages.
__device__ __forceinline__ void warp_bitonic(unsigned long long* keys, int seg) {
  const int lane = threadIdx.x & 31;
  for (int k = 2; k <= seg; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < seg; i += 32) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// 32 keys, one a lane, sorted ascending across the warp (bitonic, by
// shuffles)
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long p = __shfl_xor_sync(0xffffffffu, v, j);
      const bool take_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = take_min ? (p < v ? p : v) : (p > v ? p : v);
    }
  return v;
}

// One warp reduces a segment (a sorted top-NP, then an area of n unsorted
// keys; keys unique, EMPTY_KEY for none) to its sorted NP smallest followed
// by EMPTY_KEY, and returns the NP-th.  Where NP and n are at most 32 (the
// deployments' nprobe) it does so in registers: the area sorted across the
// warp, then merged with the top (lane l takes the smaller of top[l] and
// area[31 - l]: a bitonic sequence holding the 32 smallest, sorted by 5
// half-cleaner stages).  A larger NP sorts the whole segment.
__device__ __forceinline__ unsigned long long warp_select(unsigned long long* sk,
                                                          int n, int seg, int NP) {
  const int lane = threadIdx.x & 31;
  if (NP <= 32 && n <= 32) {
    const unsigned long long t = lane < NP ? sk[lane] : EMPTY_KEY;
    const unsigned long long a = warp_sort32(lane < n ? sk[NP + lane] : EMPTY_KEY);
    const unsigned long long ar = __shfl_sync(0xffffffffu, a, 31 - lane);
    unsigned long long v = t < ar ? t : ar;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      const unsigned long long p = __shfl_xor_sync(0xffffffffu, v, j);
      v = (lane & j) == 0 ? (p < v ? p : v) : (p > v ? p : v);
    }
    __syncwarp();
    if (lane < NP) sk[lane] = v;
  } else {
    warp_bitonic(sk, seg);
  }
  for (int x = NP + lane; x < seg; x += 32) sk[x] = EMPTY_KEY;
  __syncwarp();
  return sk[NP - 1];
}

// The warp's 2 * kQR queries: 2w + h + QG * i for half h, i < kQR; lanes of
// half h hold the area counts and thresholds of queries 2w + h + QG * i.
// Each segment whose area holds keys is reduced to its sorted top-NP.
__device__ __forceinline__ void select_warp(unsigned long long* keys, int seg, int NP,
                                            int QG, int (&cnt)[kQR],
                                            unsigned long long (&thr)[kQR]) {
  const int warp = threadIdx.x >> 5, half = (threadIdx.x >> 4) & 1;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2 * kQR; ++j) {
    const int n = __shfl_sync(0xffffffffu, cnt[j >> 1], (j & 1) * 16);
    if (n == 0) continue;  // uniform: the top is sorted, the area empty
    const int qi = 2 * warp + (j & 1) + QG * (j >> 1);
    const unsigned long long t =
        warp_select(keys + static_cast<size_t>(qi) * seg, n, seg, NP);
    if (half == (j & 1)) {
      thr[j >> 1] = t < thr[j >> 1] ? t : thr[j >> 1];
      cnt[j >> 1] = 0;
    }
  }
}

__device__ __forceinline__ void exchange(unsigned long long& a, unsigned long long& b) {
  const unsigned long long x = a < b ? a : b, y = a < b ? b : a;
  a = x;
  b = y;
}

// 8 keys sorted ascending in registers (a 19-exchange network)
__device__ __forceinline__ void sort8(unsigned long long (&v)[8]) {
  exchange(v[0], v[2]); exchange(v[1], v[3]); exchange(v[4], v[6]); exchange(v[5], v[7]);
  exchange(v[0], v[4]); exchange(v[1], v[5]); exchange(v[2], v[6]); exchange(v[3], v[7]);
  exchange(v[0], v[1]); exchange(v[2], v[3]); exchange(v[4], v[5]); exchange(v[6], v[7]);
  exchange(v[2], v[4]); exchange(v[3], v[5]);
  exchange(v[1], v[4]); exchange(v[3], v[6]);
  exchange(v[1], v[2]); exchange(v[3], v[4]); exchange(v[5], v[6]);
}

// kVec: D is a multiple of 4 and both arrays 16-byte aligned, so slices are
// staged by 16-byte copies; else by 4-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
coarse_pass1(const float* __restrict__ queries, const float* __restrict__ cents,
             int Q, int N, int D, int NP, int QT, int chunk, int seg,
             unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [QT][seg]
  float* stage = reinterpret_cast<float*>(keys + static_cast<size_t>(QT) * seg);
  const int stage_floats = (QT + kTC) * kRow;  // a step: QT query rows, kTC centroid rows

  const int QG = QT / kQR;  // query groups; blockDim.x = QG * kCG
  const int q0 = blockIdx.x * QT, s = blockIdx.y, S = gridDim.y;
  const int n0 = s * chunk, n1 = min(N, n0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nq = min(QT, Q - q0);
  // lanes 0-15 of warp w hold query group 2w, lanes 16-31 group 2w + 1:
  // the warp holds every candidate of its 2 * kQR queries, 2w + h + QG * i
  const int half = lane >> 4, hl = lane & 15;
  const int qg = tid / kCG, cg = tid % kCG;
  // the area a query fills between selections: up to 32 keys where NP <=
  // 32 (selected in registers), else the segment's rest
  const int CB = NP <= 32 ? min(seg - NP, 32) : seg - NP;
  const int nsl = (D + kDK - 1) / kDK;
  const int ntiles = (n1 - n0 + kTC - 1) / kTC;
  const int nsteps = ntiles * nsl;

  // this warp's segments, all empty
  for (int j = 0; j < 2 * kQR; ++j) {
    const int qi = 2 * warp + (j & 1) + QG * (j >> 1);
    for (int x = lane; x < seg; x += 32) keys[qi * seg + x] = EMPTY_KEY;
  }

  // step st: slice st % nsl of tile st / nsl, rows zero-filled past the
  // queries, the chunk and D
  auto load_step = [&](int st, int buf) {
    const int tile = st / nsl, d0 = (st - tile * nsl) * kDK;
    const int c0 = n0 + tile * kTC;
    float* dst = stage + static_cast<size_t>(buf) * stage_floats;
    constexpr int VE = kVec ? 4 : 1;     // floats a copy
    constexpr int UPR = kDK / VE;        // copies a row
    for (int x = tid; x < (QT + kTC) * UPR; x += nthreads) {
      const int r = x / UPR, d = d0 + (x - r * UPR) * VE;
      const bool is_q = r < QT;
      const int row = is_q ? q0 + r : c0 + (r - QT);
      const bool ok = (is_q ? r < nq : row < n1) && d < D;
      const float* src = (is_q ? queries : cents) +
                         (ok ? static_cast<size_t>(row) * D + d : 0);
      float* to = dst + r * kRow + (d - d0);
      if constexpr (kVec)
        cp_async16_zfill(to, src, ok);
      else
        cp_async4_zfill(to, src, ok);
    }
  };

  float acc[kQR][kCR], cn[kCR];
  float qpart[2 * kQR];  // ||q||^2 of the warp's queries, lane-strided sums
  float qn[kQR];         // ||q||^2 of this lane's queries
  unsigned long long thr[kQR];  // keys enter a query's area only below this
  int cnt[kQR];                 // keys in each query's area
#pragma unroll
  for (int i = 0; i < kQR; ++i) {
    thr[i] = EMPTY_KEY;
    cnt[i] = 0;
    qn[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 2 * kQR; ++j) qpart[j] = 0.f;

  if (nsteps > 0) load_step(0, 0);
  cp_async_commit();
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait(0);
    __syncthreads();  // step st is in; step st - 1's buffer is free
    if (st + 1 < nsteps) load_step(st + 1, (st + 1) & 1);
    cp_async_commit();
    const int tile = st / nsl, sl = st - tile * nsl;
    if (sl == 0) {
#pragma unroll
      for (int k = 0; k < kCR; ++k) {
        cn[k] = 0.f;
#pragma unroll
        for (int i = 0; i < kQR; ++i) acc[i][k] = 0.f;
      }
    }
    const float* qb = stage + static_cast<size_t>(st & 1) * stage_floats;
    const float* cb = qb + QT * kRow;
    if (tile == 0) {
      // ||q||^2: lane l sums dims l, l + 32, ... in order (this slice's dim
      // d0 + lane), then a butterfly
#pragma unroll
      for (int j = 0; j < 2 * kQR; ++j) {
        const float x = qb[(2 * warp + (j & 1) + QG * (j >> 1)) * kRow + lane];
        qpart[j] = fmaf(x, x, qpart[j]);
      }
    }
#pragma unroll 2
    for (int dd = 0; dd < kDK; dd += 4) {
      float4 qv[kQR], cv[kCR];
#pragma unroll
      for (int i = 0; i < kQR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qb + (qg + QG * i) * kRow + dd);
#pragma unroll
      for (int k = 0; k < kCR; ++k)
        cv[k] = *reinterpret_cast<const float4*>(cb + (cg + kCG * k) * kRow + dd);
#pragma unroll
      for (int k = 0; k < kCR; ++k) {
        cn[k] = fmaf(cv[k].x, cv[k].x, cn[k]);
        cn[k] = fmaf(cv[k].y, cv[k].y, cn[k]);
        cn[k] = fmaf(cv[k].z, cv[k].z, cn[k]);
        cn[k] = fmaf(cv[k].w, cv[k].w, cn[k]);
      }
#pragma unroll
      for (int i = 0; i < kQR; ++i)
#pragma unroll
        for (int k = 0; k < kCR; ++k) {
          acc[i][k] = fmaf(qv[i].x, cv[k].x, acc[i][k]);
          acc[i][k] = fmaf(qv[i].y, cv[k].y, acc[i][k]);
          acc[i][k] = fmaf(qv[i].z, cv[k].z, acc[i][k]);
          acc[i][k] = fmaf(qv[i].w, cv[k].w, acc[i][k]);
        }
    }
    if (sl != nsl - 1) continue;

    if (tile == 0) {
#pragma unroll
      for (int j = 0; j < 2 * kQR; ++j) {
        const float v = warp_sum(qpart[j]);
        if (half == (j & 1)) qn[j >> 1] = v;
      }
    }
    // the tile's keys, selected by the warp that holds them
    const int c0 = n0 + tile * kTC;
#define COARSE_KEY(i, k)                                                      \
  (qg + QG * (i) < nq && c0 + cg + kCG * (k) < n1                             \
       ? make_key(l2_from_parts(qn[i], cn[k], acc[i][k]), c0 + cg + kCG * (k)) \
       : EMPTY_KEY)
    if (tile == 0 && NP <= 16 * kCR) {
      // a chunk's first tile: the largest of the 16 lanes' m-th smallest
      // keys (m = ceil(NP / 16)) has 16m >= NP of the tile's keys at or
      // below it, so no key above it is among the NP best
      const int m = (NP + 15) / 16;
#pragma unroll
      for (int i = 0; i < kQR; ++i) {
        unsigned long long v[kCR];
#pragma unroll
        for (int k = 0; k < kCR; ++k) v[k] = COARSE_KEY(i, k);
        sort8(v);
        unsigned long long u = v[0];
#pragma unroll
        for (int k = 1; k < kCR; ++k)
          if (k < m) u = v[k];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          const unsigned long long w = __shfl_xor_sync(0xffffffffu, u, o);
          u = w > u ? w : u;
        }
        if (u != EMPTY_KEY && u + 1 < thr[i]) thr[i] = u + 1;
      }
    }
    unsigned placed = 0;  // bit i * kCR + k: that key is placed or dropped
    while (true) {
      unsigned want = 0;  // this lane's keys that enter
#pragma unroll
      for (int i = 0; i < kQR; ++i)
#pragma unroll
        for (int k = 0; k < kCR; ++k)
          if (COARSE_KEY(i, k) < thr[i]) want |= 1u << (i * kCR + k);
      want &= ~placed;
      placed |= ~want;  // the others are dropped
      const unsigned any = __reduce_or_sync(0xffffffffu, want);
      if (any == 0) break;
      bool over = false;
#pragma unroll
      for (int i = 0; i < kQR; ++i)
#pragma unroll
        for (int k = 0; k < kCR; ++k) {
          const unsigned bit = 1u << (i * kCR + k);
          if (!(any & bit)) continue;  // uniform: no lane has this key
          const bool w = want & bit;
          const unsigned mb = __ballot_sync(0xffffffffu, w);
          const unsigned hm = half ? mb >> 16 : mb & 0xffffu;
          const int at = cnt[i] + __popc(hm & ((1u << hl) - 1));
          if (w && at < CB) {
            keys[static_cast<size_t>(qg + QG * i) * seg + NP + at] = COARSE_KEY(i, k);
            placed |= bit;
          }
          if (w && at >= CB) over = true;
          cnt[i] = min(cnt[i] + __popc(hm), CB);
        }
      if (!__any_sync(0xffffffffu, over)) break;
      select_warp(keys, seg, NP, QG, cnt, thr);
    }
#undef COARSE_KEY
  }
  cp_async_wait(0);
  select_warp(keys, seg, NP, QG, cnt, thr);
  for (int j = 0; j < 2 * kQR; ++j) {
    const int qi = 2 * warp + (j & 1) + QG * (j >> 1);
    if (qi >= nq) continue;
    for (int r = lane; r < NP; r += 32)
      partial[(static_cast<size_t>(q0 + qi) * S + s) * NP + r] =
          keys[static_cast<size_t>(qi) * seg + r];
  }
}

}  // namespace

// queries [Q, D] f32, cents [N, D] f32 -> out_i [Q, NP] i32, out_d [Q, NP]
// f32, both ascending by (distance, centroid id).  Requires 0 < NP <= N.
// Queries go in tiles of QT (8, 16, 32 or 64; a block of QT / 2 * 16
// threads); the centroids are cut into S chunks of `chunk` (a multiple of
// 128, S * chunk >= N); every query keeps a segment of seg keys (a power of
// two > NP); partial [Q, S, NP] u64 is scratch.
extern "C" int coarse_topk_f32(const float* queries, const float* cents, int Q,
                               int N, int D, int NP, int QT, int seg, int chunk,
                               int S, unsigned long long* partial, int* out_i,
                               float* out_d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(QT) * seg * sizeof(unsigned long long) +
                      2 * static_cast<size_t>(QT + kTC) * kRow * sizeof(float);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  const dim3 grid((Q + QT - 1) / QT, S);
  const int threads = QT / kQR * kCG;
  cudaError_t err;
  if (vec) {
    err = allow_smem(coarse_pass1<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    coarse_pass1<true><<<grid, threads, smem, st>>>(queries, cents, Q, N, D, NP, QT,
                                                   chunk, seg, partial);
  } else {
    err = allow_smem(coarse_pass1<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    coarse_pass1<false><<<grid, threads, smem, st>>>(queries, cents, Q, N, D, NP, QT,
                                                    chunk, seg, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge_sorted(partial, Q, S, NP, out_d, out_i, st);
}
