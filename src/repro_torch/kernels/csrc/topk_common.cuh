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
constexpr int kSmemBytes = 232448;  // shared memory a block may use (Hopper)

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
// A thread takes one compare-exchange pair (i, i + j) of a stage at a time,
// so no thread idles on the pair's upper half.
__device__ __forceinline__ void bitonic_sort(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j clear
        const unsigned long long a = s[i], b = s[i | j];
        const bool up = (i & k) == 0;
        if ((a > b) == up) {
          s[i] = b;
          s[i | j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// the least power of two >= n (n >= 1), on the device
__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
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
// ascending): one block per query.  With m = min(K, ceil(2K / S)), the
// runs' first m keys are at least K keys, so the K-th smallest of them is a
// bound: no key above it is among the K best.  The block finds it by ranking those S*m
// keys among themselves, counts each run's keys at or below it (a binary
// search), gathers them by a prefix sum into a buffer of nbuf keys, sorts
// them (bitonic, next_pow2 of their count) and writes the first K decoded.
// Sorted runs of random chunks leave little more than K keys under the
// bound, where sorting all S*K keys or ranking each in the other runs
// costs up to S times more.  Where more keys than nbuf fall under the
// bound, each is placed by its rank: its position in its run plus the
// number of smaller keys in each other run.  Non-empty keys are unique
// (distance, location) pairs, so the ranks are distinct; output places no
// key reaches stay EMPTY_KEY.
__global__ void __launch_bounds__(256)
merge_sorted_partials(const unsigned long long* __restrict__ partial, int S,
                      int K, int nbuf, float* __restrict__ out_d,
                      int* __restrict__ out_i) {
  extern __shared__ unsigned long long runs[];  // [S*K], [nbuf] gathered, [K]
  unsigned long long* buf = runs + static_cast<size_t>(S) * K;
  unsigned long long* top = buf + nbuf;
  __shared__ unsigned long long bound_s;
  __shared__ int warp_sum_s[8];
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const unsigned long long* in = partial + static_cast<size_t>(qi) * S * K;
  for (int i = tid; i < S * K; i += blockDim.x) runs[i] = in[i];
  for (int i = tid; i < K; i += blockDim.x) top[i] = EMPTY_KEY;
  if (tid == 0) bound_s = EMPTY_KEY;
  __syncthreads();

  // the bound: the K-th smallest of the runs' first m keys (key t of them
  // is position t / S of run t % S), about 2K of them; EMPTY_KEY where fewer
  // than K are keys
  const int m = min(K, (2 * K + S - 1) / S), T = S * m;
  for (int t = tid; t < T; t += blockDim.x) {
    const unsigned long long x = runs[static_cast<size_t>(t % S) * K + t / S];
    if (x == EMPTY_KEY) continue;
    int rank = 0;
    for (int r = 0; r < S; ++r)
      for (int pos = 0; pos < m; ++pos) rank += runs[static_cast<size_t>(r) * K + pos] < x;
    if (rank == K - 1) bound_s = x;
  }
  __syncthreads();
  const unsigned long long bnd = bound_s;

  // thread t counts the keys at or below the bound in runs [r0, r1)
  const int r0 = static_cast<int>(static_cast<long long>(S) * tid / blockDim.x);
  const int r1 = static_cast<int>(static_cast<long long>(S) * (tid + 1) / blockDim.x);
  int mine = 0;
  for (int r = r0; r < r1; ++r) {
    const unsigned long long* run = runs + static_cast<size_t>(r) * K;
    int lo = 0, hi = K;  // keys of run r at or below the bound
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (run[mid] <= bnd) lo = mid + 1; else hi = mid;
    }
    mine += lo;
  }
  int incl = mine;  // inclusive prefix sum over the threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum_s[warp] = incl;
  __syncthreads();
  int before = incl - mine, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) before += warp_sum_s[w];
    total += warp_sum_s[w];
  }

  if (total <= nbuf) {
    for (int r = r0; r < r1; ++r) {
      const unsigned long long* run = runs + static_cast<size_t>(r) * K;
      for (int j = 0; j < K && run[j] <= bnd; ++j) buf[before++] = run[j];
    }
    int n = 1;
    while (n < total) n <<= 1;
    for (int i = total + tid; i < n; i += blockDim.x) buf[i] = EMPTY_KEY;
    __syncthreads();
    bitonic_sort(buf, n);
    for (int i = tid; i < K; i += blockDim.x)
      store_key(i < n ? buf[i] : EMPTY_KEY, &out_d[static_cast<size_t>(qi) * K + i],
                &out_i[static_cast<size_t>(qi) * K + i]);
    return;
  }
  for (int i = tid; i < S * K; i += blockDim.x) {
    const int pos = i / S, a = i - pos * S;  // position pos of run a
    const unsigned long long x = runs[static_cast<size_t>(a) * K + pos];
    if (x == EMPTY_KEY || x > bnd) continue;
    int rank = pos;
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
  for (int i = tid; i < K; i += blockDim.x)
    store_key(top[i], &out_d[static_cast<size_t>(qi) * K + i],
              &out_i[static_cast<size_t>(qi) * K + i]);
}

// the gather buffer: every key's room where shared memory allows, else the
// largest power of two beside the runs (down to K), up to 8192 keys
inline int merge_sorted_nbuf(int S, int K) {
  const long long room = kSmemBytes / 8 - static_cast<long long>(S + 1) * K;
  int n = 1;
  while (n < S * K && n < 8192 && 2LL * n <= room) n <<= 1;
  return n;
}

inline int launch_merge_sorted(const unsigned long long* partial, int Q, int S,
                               int K, float* out_d, int* out_i, cudaStream_t st) {
  const int nbuf = merge_sorted_nbuf(S, K);
  const size_t smem =
      (static_cast<size_t>(S + 1) * K + nbuf) * sizeof(unsigned long long);
  const cudaError_t err = allow_smem(merge_sorted_partials, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sorted_partials<<<Q, 256, smem, st>>>(partial, S, K, nbuf, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// ---- the member-split scans (ivf_block_topk.cu, ivf_block_topk_int8.cu,
// ivf_pq_block_topk.cu) ----

constexpr int kListThreads = 256;  // list_members' block

// One block per query: the query's member candidates (owner in its probe
// list) compacted in candidate order by warp ballots into members[q][0..n),
// their count into counts[q], and, where slots is not null, the probe slot
// p with probe[q][p] == owner of each (probe ids are distinct: one match).
// A thread loads the owners of 8 chunks at once, so the loads' latency is
// paid once for 8 * 256 candidates.
__global__ void __launch_bounds__(kListThreads)
list_members(const int* __restrict__ owners, int C, const int* __restrict__ probe,
             int NP, int* __restrict__ members, int* __restrict__ slots,
             int* __restrict__ counts) {
  extern __shared__ int probes[];  // [NP]
  __shared__ int warp_n[kListThreads / 32];
  __shared__ int base_s;
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = threadIdx.x; p < NP; p += blockDim.x)
    probes[p] = probe[static_cast<size_t>(qi) * NP + p];
  if (threadIdx.x == 0) base_s = 0;
  __syncthreads();
  int* out = members + static_cast<size_t>(qi) * C;
  constexpr int kOwners = 8;  // owners a thread loads at once
  for (int g0 = 0; g0 < C; g0 += kOwners * kListThreads) {
    int own[kOwners];
#pragma unroll
    for (int e = 0; e < kOwners; ++e) {
      const int c = g0 + e * kListThreads + threadIdx.x;
      own[e] = c < C ? owners[c] : -1;
    }
#pragma unroll
    for (int e = 0; e < kOwners; ++e) {  // in candidate order
      if (g0 + e * kListThreads >= C) break;  // uniform over the block
      const int c = g0 + e * kListThreads + threadIdx.x;
      int ps = -1;
      if (own[e] >= 0)
        for (int p = 0; p < NP; ++p)
          if (probes[p] == own[e]) ps = p;
      const bool m = ps >= 0;
      const unsigned mask = __ballot_sync(0xffffffffu, m);
      if (lane == 0) warp_n[warp] = __popc(mask);
      __syncthreads();
      int off = base_s;
      for (int w = 0; w < warp; ++w) off += warp_n[w];
      if (m) {
        const int at = off + __popc(mask & ((1u << lane) - 1));
        out[at] = c;
        if (slots != nullptr) slots[static_cast<size_t>(qi) * C + at] = ps;
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int w = 0; w < kListThreads / 32; ++w) base_s += warp_n[w];
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) counts[qi] = base_s;
}

inline cudaError_t launch_list_members(const int* owners, int C, const int* probe,
                                       int Q, int NP, int* members, int* slots,
                                       int* counts, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(NP) * sizeof(int);
  const cudaError_t err = allow_smem(list_members, smem);
  if (err != cudaSuccess) return err;
  list_members<<<Q, kListThreads, smem, st>>>(owners, C, probe, NP, members,
                                              slots, counts);
  return cudaGetLastError();
}

// List the occupied, live slots (id != -1, live != 0) of n_blk pool blocks
// (their ids in gblk[], shared memory) by warp ballots: each thread tests
// kLoads slots at once, their ids and live bytes loaded together, and
// emit(at, slot, j) records slot (of gblk[j]) at list place `at`; *n_list
// (shared, zero on entry) counts them.  Every thread of the block calls it;
// the caller's barrier makes the list visible.
template <int kLoads, typename Emit>
__device__ __forceinline__ void list_live_slots(const int* gblk, int n_blk, int T_m,
                                                const int* __restrict__ pool_ids,
                                                const uint8_t* __restrict__ pool_live,
                                                int* n_list, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int n_slots = n_blk * T_m;
  for (int x0 = 0; x0 < n_slots; x0 += kLoads * blockDim.x) {
    int slot[kLoads], blk[kLoads];
    bool ok[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int x = x0 + k * blockDim.x + threadIdx.x;
      const int jj = x / T_m;
      blk[k] = jj;
      slot[k] = x < n_slots ? gblk[jj] * T_m + (x - jj * T_m) : 0;
      int id = -1;  // the id and live byte of a slot load together
      uint8_t live = 0;
      if (x < n_slots) {
        id = pool_ids[slot[k]];
        live = pool_live[slot[k]];
      }
      ok[k] = id != -1 && live != 0;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const unsigned mask = __ballot_sync(0xffffffffu, ok[k]);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(n_list, __popc(mask));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (ok[k]) emit(base + __popc(mask & ((1u << lane) - 1)), slot[k], blk[k]);
    }
  }
}

// Sort a[0..n) in runs of 32 keys, a warp a run, in registers: a bitonic
// network over the lanes by shuffles, no barrier.  The last run is padded
// with EMPTY_KEY, written back too.  The caller's barrier makes the runs
// visible.
__device__ __forceinline__ void sort_runs32(unsigned long long* a, int n) {
  const int lane = threadIdx.x & 31;
  for (int run = threadIdx.x >> 5; run * 32 < n; run += blockDim.x >> 5) {
    const int at = run * 32 + lane;
    unsigned long long x = at < n ? a[at] : EMPTY_KEY;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, j);
        const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
        x = keep_min ? (y < x ? y : x) : (y < x ? x : y);
      }
    }
    a[at] = x;
  }
}

// The keys of a sorted run of 32 below x (at or below it, with le).
__device__ __forceinline__ int count_in_run32(const unsigned long long* run,
                                              unsigned long long x, bool le) {
  int lo = 0;
#pragma unroll
  for (int s = 32; s > 0; s >>= 1)
    if (lo + s <= 32 && (le ? run[lo + s - 1] <= x : run[lo + s - 1] < x)) lo += s;
  return lo;
}

// The keys of sorted a[0..n) at or below x.
__device__ __forceinline__ int count_at_or_below(const unsigned long long* a, int n,
                                                 unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

constexpr int kRankKeys = 4;   // keys a thread places in merge_area
constexpr int kRankRuns = 16;  // area runs merge_area ranks against, at most

// Threshold selection: keys[0..K) hold the sorted top-K so far, keys[K..seg)
// a candidate area that takes a key only below the K'-th best (*thr): its
// c = *cnt keys first, EMPTY_KEY after them, so no area key equals a top key
// or EMPTY_KEY.  Merge the area into the top-K, empty it, and take the new
// K-th best as the threshold.  Where the area is at most kRankRuns runs of
// 32 and the K + c keys at most kRankKeys a thread, the area is sorted in
// runs by warps (sort_runs32) and each key placed at its rank: its place in
// its own run (or in the top) plus the keys below it in every other run and
// (for an area key) the top keys below it, by binary searches; three
// barriers in all.  Else the top and the area are sorted together
// (bitonic, a barrier a stage).  Called by every thread after a barrier;
// returns synchronized.
__device__ __forceinline__ void merge_area(unsigned long long* keys, int seg, int K,
                                           int* cnt, unsigned long long* thr) {
  const int c = *cnt;
  const int runs = (c + 31) >> 5;
  unsigned long long* area = keys + K;
  if (runs <= kRankRuns && K + 32 * runs <= seg &&
      K + c <= kRankKeys * static_cast<int>(blockDim.x)) {
    sort_runs32(area, c);
    __syncthreads();
    unsigned long long x[kRankKeys];
    int rank[kRankKeys];
#pragma unroll
    for (int e = 0; e < kRankKeys; ++e) {
      const int i = threadIdx.x + e * blockDim.x;  // top, then area
      x[e] = 0;
      rank[e] = K;  // unplaced
      if (i < K) {
        x[e] = keys[i];
        rank[e] = i;
        for (int r = 0; r < runs; ++r) rank[e] += count_in_run32(area + 32 * r, x[e], false);
      } else if (i < K + c) {
        const int j = i - K, a = j >> 5;
        x[e] = area[j];
        rank[e] = (j & 31) + count_at_or_below(keys, K, x[e]);
        for (int r = 0; r < runs; ++r)
          if (r != a) rank[e] += count_in_run32(area + 32 * r, x[e], false);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kRankKeys; ++e)
      if (rank[e] < K) keys[rank[e]] = x[e];
    for (int i = K + threadIdx.x; i < K + 32 * runs; i += blockDim.x) keys[i] = EMPTY_KEY;
  } else {
    const int n = min(seg, pow2_at_least(K + c));
    bitonic_sort(keys, n);
    for (int i = K + threadIdx.x; i < n; i += blockDim.x) keys[i] = EMPTY_KEY;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *thr = keys[K - 1];
    *cnt = 0;
  }
  __syncthreads();
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

// 4 bytes through L1 (cp.async.ca: the only form below 16 bytes), zero-
// filled when !valid, for rows that are not 16-byte aligned
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
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
