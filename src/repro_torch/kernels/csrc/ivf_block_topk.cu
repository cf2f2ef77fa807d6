// Fused IVF block scan with a streaming top-K' (the search's hot loop).
//
// Replaces the TPU kernel `_topk_kernel` / `ivf_block_topk` in
// src/repro/kernels/ivf_scan.py (body at :313, pallas_call at :448).  For
// every query it scores the rows of the candidate blocks whose owning
// cluster is in the query's probe list, leaves out empty slots (id -1) and
// tombstones (live == 0), and returns the K' nearest as ascending
// (distance, packed location block*T + offset).  Payloads are float32 or
// bfloat16; for bf16 the query is rounded to bf16, the products are taken
// and summed in float32, and ||v||^2 comes from the bf16 value widened to
// float32, as in the TPU kernel.
//
// What bounds it on an H100: bytes.  The function must read the payload of
// the occupied, live slots of the candidate blocks once, and the ids and
// live bytes of every candidate block: at SIFT1M (about 1570 blocks of 1024
// slots, about 254 occupied, D = 128) about 0.2 GB in float32, 0.06 ms at
// 3.35 TB/s, against a few hundred MFLOP of dot products.
//
// Design, in three launches:
// * list_members (topk_common.cuh), one block per query: the query's member
//   candidates (owner in its probe list) compacted in candidate order, by
//   warp ballots.
// * Pass 1, grid (query, split): a query's members are cut evenly across
//   its S blocks (the TPU kernel walks every candidate and masks the
//   product afterwards; PR 11's first design here split the candidates, so
//   a block got anywhere from 0 to a dozen members).  For a group of member
//   blocks the block reads the T ids and live bytes and compacts the
//   occupied, live slots into a list in shared memory; only their rows are
//   loaded, by 16-byte cp.async copies, in tiles of R rows through a ring
//   of ns tiles in shared memory, the next tiles loading while this one is
//   scored.  Eight
//   threads score a row against the query in shared memory (three shuffles
//   per sum).  A key enters a candidate area only below the running K'-th
//   best (the threshold), and the area is sorted with the top-K' only when
//   a tile could overflow it, and once at the end (merge_area);
//   PR 11's design sorted K'+T keys per member block.  The split's sorted
//   K' best go to a partial buffer [Q, S, K'].
// * Pass 2 (merge_sorted_partials) ranks the S sorted runs of a query and
//   writes the first K'.
// Keys are unique per slot, so the order in which rows are scored does not
// change the result.  Rows whose bytes are not a multiple of 16 are staged
// by plain loads instead of cp.async.
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;  // threads scoring one row
constexpr int kRowsPerPass = kThreads / kRowThreads;
constexpr int kLoads = 8;  // slots a thread tests at once when listing
// Blocks an SM holds by shared memory at SIFT1M (kernels/BUDGETS.md), the
// launch bound's minimum: a cap of 64 registers.  With no minimum ptxas
// aims at 5 blocks for <bf16, true> (48 registers) and spills long-lived
// scalars (the split's member range, the query's norm) that the member
// and tile loops reload.
constexpr int kMinBlocks = 4;

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

// kVec: rows are a multiple of 16 bytes and the pool 16-byte aligned, so
// rows are staged by cp.async and read as 16-byte vectors.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_topk_pass1(const float* __restrict__ queries, const T* __restrict__ pool,
                 int T_m, int D, const int* __restrict__ block_ids,
                 const int* __restrict__ members, const int* __restrict__ counts,
                 int C, const int* __restrict__ pool_ids,
                 const uint8_t* __restrict__ pool_live, int K, int R, int L,
                 int seg, int ns, unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = (D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);  // [Dp] the query as scored
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(qs + Dp);  // [seg]: top-K', area
  T* stage = reinterpret_cast<T*>(keys + seg);        // [ns][R][D]
  int* list = reinterpret_cast<int*>(stage + static_cast<size_t>(ns) * R * D);  // [L]
  int* gblk = list + L;  // [L / T_m] the group's member blocks
  __shared__ float qn_s;
  __shared__ int cnt, n_list;  // keys in the area; slots in the list
  __shared__ unsigned long long thr;  // the K'-th best so far

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_mem = counts[qi];
  const int m0 = static_cast<int>(static_cast<long long>(n_mem) * s / S);
  const int m1 = static_cast<int>(static_cast<long long>(n_mem) * (s + 1) / S);
  const int* mem = members + static_cast<size_t>(qi) * C;
  const float* q = queries + static_cast<size_t>(qi) * D;
  const int CB = seg - K;  // candidate area, >= R

  for (int d = tid; d < Dp; d += kThreads) qs[d] = d < D ? round_query<T>(q[d]) : 0.f;
  for (int i = tid; i < seg; i += kThreads) keys[i] = EMPTY_KEY;
  if (tid == 0) {
    cnt = 0;
    thr = EMPTY_KEY;
  }
  if (warp == 0) {  // ||q||^2 of the float32 query, as the reference takes it
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v = fmaf(q[d], q[d], v);
    v = warp_sum(v);
    if (lane == 0) qn_s = v;
  }
  __syncthreads();
  const float qn = qn_s;

  constexpr int VE = kVec ? 16 / sizeof(T) : 1;  // values per unit
  const int NU = D / VE;                            // units per row
  const int sub = tid % kRowThreads, rr = tid / kRowThreads;
  const int per_group = max(1, L / T_m);  // member blocks per list

  // a thread's (row, unit) in a tile, stepped by kThreads units without a
  // division
  const int r_first = tid / NU, u_first = tid % NU;
  const int r_step = kThreads / NU, u_step = kThreads % NU;
  auto stage_tile = [&](int i, int buf, int n) {
    const int rows = min(R, n - i * R);
    T* dst = stage + static_cast<size_t>(buf) * R * D;
    const int* slots = list + i * R;
    int r = r_first, u = u_first;
    for (int x = tid; x < rows * NU; x += kThreads) {
      const size_t row = static_cast<size_t>(slots[r]);
      if constexpr (kVec)
        cp_async16(reinterpret_cast<uint4*>(dst + r * D) + u,
                   reinterpret_cast<const uint4*>(pool + row * D) + u);
      else
        dst[r * D + u] = pool[row * D + u];
      r += r_step;
      u += u_step;
      if (u >= NU) {
        u -= NU;
        ++r;
      }
    }
  };

  for (int mi = m0; mi < m1; mi += per_group) {
    // the occupied, live slots of this group's member blocks
    const int mend = min(m1, mi + per_group);
    for (int j = mi + tid; j < mend; j += kThreads) gblk[j - mi] = max(block_ids[mem[j]], 0);
    if (tid == 0) n_list = 0;
    __syncthreads();
    list_live_slots<kLoads>(gblk, mend - mi, T_m, pool_ids, pool_live, &n_list,
                            [&](int at, int slot, int) { list[at] = slot; });
    __syncthreads();
    const int n = n_list;
    const int ntiles = (n + R - 1) / R;
    for (int i = 0; i < ns - 1; ++i) {
      if (i < ntiles) stage_tile(i, i, n);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      // into the buffer of tile i - 1, free since the barrier ending it
      if (i + ns - 1 < ntiles) stage_tile(i + ns - 1, (i + ns - 1) % ns, n);
      cp_async_commit();
      cp_async_wait(ns - 1);  // tile i has landed (this thread's copies)
      // the area's count is stable here: its last change came before the
      // barrier that ended the previous tile
      const bool full = cnt > CB - R;
      __syncthreads();
      if (full) merge_area(keys, seg, K, &cnt, &thr);
      const T* rows = stage + static_cast<size_t>(i % ns) * R * D;
      const int r_base = i * R, nr = min(R, n - r_base);
      const unsigned long long th = thr;
      for (int r0 = 0; r0 < nr; r0 += kRowsPerPass) {  // uniform over the block
        const int r = r0 + rr;
        float dot = 0.f, vn = 0.f;
        if (r < nr) {
          const T* row = rows + static_cast<size_t>(r) * D;
          // unrolled twice: at the 64-register cap, deeper unrolling of
          // <float, true> holds more 16-byte loads in flight than fit
#pragma unroll 2
          for (int u = sub; u < NU; u += kRowThreads) {
            if constexpr (kVec) {
              float v[VE];
              widen16<T>(reinterpret_cast<const uint4*>(row)[u], v);
              const float4* qv = reinterpret_cast<const float4*>(qs + u * VE);
#pragma unroll
              for (int h = 0; h < VE / 4; ++h) {
                const float4 qq = qv[h];
                dot = fmaf(qq.x, v[4 * h], dot);
                dot = fmaf(qq.y, v[4 * h + 1], dot);
                dot = fmaf(qq.z, v[4 * h + 2], dot);
                dot = fmaf(qq.w, v[4 * h + 3], dot);
              }
#pragma unroll
              for (int e = 0; e < VE; ++e) vn = fmaf(v[e], v[e], vn);
            } else {
              const float v = widen<T>(row[u]);
              dot = fmaf(qs[u], v, dot);
              vn = fmaf(v, v, vn);
            }
          }
        }
#pragma unroll
        for (int o = kRowThreads / 2; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
          vn += __shfl_xor_sync(0xffffffffu, vn, o);
        }
        if (sub == 0 && r < nr) {
          const unsigned long long key =
              make_key(l2_from_parts(qn, vn, dot), list[r_base + r]);
          if (key < th) keys[K + atomicAdd(&cnt, 1)] = key;
        }
      }
      __syncthreads();  // the tile's buffer and the area are settled
    }
    cp_async_wait(0);
  }
  __syncthreads();
  merge_area(keys, seg, K, &cnt, &thr);
  unsigned long long* out = partial + (static_cast<size_t>(qi) * S + s) * K;
  for (int i = tid; i < K; i += kThreads) out[i] = keys[i];
}

template <typename T, bool kVec>
int launch_pass1(const float* queries, const void* pool, int T_m, int D,
                 const int* block_ids, const int* members, const int* counts,
                 int C, int S, const int* pool_ids, const uint8_t* pool_live,
                 int Q, int K, int R, int L, int seg, int ns,
                 unsigned long long* partial, cudaStream_t st) {
  const size_t smem = static_cast<size_t>((D + 3) & ~3) * sizeof(float) +
                      static_cast<size_t>(seg) * sizeof(unsigned long long) +
                      static_cast<size_t>(ns) * R * D * sizeof(T) +
                      static_cast<size_t>(L + L / T_m) * sizeof(int);
  const cudaError_t err = allow_smem(block_topk_pass1<T, kVec>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_topk_pass1<T, kVec><<<dim3(Q, S), kThreads, smem, st>>>(
      queries, static_cast<const T*>(pool), T_m, D, block_ids, members, counts,
      C, pool_ids, pool_live, K, R, L, seg, ns, partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* queries, const void* pool, int T_m, int D,
           const int* block_ids, const int* owners, int C, int S,
           const int* pool_ids, const uint8_t* pool_live, const int* probe,
           int Q, int NP, int K, int R, int L, int seg, int ns, int vec, int* members,
           int* counts, unsigned long long* partial, float* out_d, int* out_i,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_list_members(owners, C, probe, Q, NP, members, nullptr, counts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = vec
      ? launch_pass1<T, true>(queries, pool, T_m, D, block_ids, members, counts,
                              C, S, pool_ids, pool_live, Q, K, R, L, seg, ns, partial, st)
      : launch_pass1<T, false>(queries, pool, T_m, D, block_ids, members, counts,
                               C, S, pool_ids, pool_live, Q, K, R, L, seg, ns, partial, st);
  if (rc != 0) return rc;
  return launch_merge_sorted(partial, Q, S, K, out_d, out_i, st);
}

}  // namespace

// queries [Q, D] f32; pool [P, T_m, D] f32 | bf16; block_ids, owners [C] i32;
// pool_ids [P, T_m] i32; pool_live [P, T_m] u8; probe [Q, NP] i32;
// -> out_d [Q, K] f32, out_i [Q, K] i32.  Scratch: members [Q, C] i32,
// counts [Q] i32, partial [Q, S, K] u64.  Each query's members are cut
// into S splits; rows are staged in tiles of R, ns (2..4) tiles in a
// ring, through lists of L >= T_m slots; seg (a power of two >= K + 2R)
// keys hold the top-K and the candidate area.  vec != 0: D * sizeof is a multiple of 16
// and the pool 16-byte aligned.
extern "C" int ivf_block_topk_f32(const float* queries, const void* pool,
                                  int T_m, int D, const int* block_ids,
                                  const int* owners, int C, int S,
                                  const int* pool_ids, const uint8_t* pool_live,
                                  const int* probe, int Q, int NP, int K, int R,
                                  int L, int seg, int ns, int vec, int* members,
                                  int* counts, unsigned long long* partial,
                                  float* out_d, int* out_i, void* stream) {
  return launch<float>(queries, pool, T_m, D, block_ids, owners, C, S,
                       pool_ids, pool_live, probe, Q, NP, K, R, L, seg, ns, vec,
                       members, counts, partial, out_d, out_i, stream);
}

extern "C" int ivf_block_topk_bf16(const float* queries, const void* pool,
                                   int T_m, int D, const int* block_ids,
                                   const int* owners, int C, int S,
                                   const int* pool_ids, const uint8_t* pool_live,
                                   const int* probe, int Q, int NP, int K, int R,
                                   int L, int seg, int ns, int vec, int* members,
                                   int* counts, unsigned long long* partial,
                                   float* out_d, int* out_i, void* stream) {
  return launch<__nv_bfloat16>(queries, pool, T_m, D, block_ids, owners, C, S,
                               pool_ids, pool_live, probe, Q, NP, K, R, L, seg,
                               ns, vec, members, counts, partial, out_d, out_i,
                               stream);
}
