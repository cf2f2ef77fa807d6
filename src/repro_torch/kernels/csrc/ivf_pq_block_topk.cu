// Fused IVF block scan with a streaming top-K' over PQ code blocks (IVFPQ).
//
// Replaces the TPU kernel `_pq_topk_kernel` / `ivf_pq_block_topk` in
// src/repro/kernels/ivf_scan.py (body at :892, pallas_call at :1025).  Pool
// rows are uint8 PQ codes [T, M] of residuals against their cluster's
// centroid; queries arrive as one ADC table per (query, probe) pair, lut
// [Q, NP, M, 256].  For every query it scores the occupied, live rows of the
// candidate blocks whose owner is in the query's probe list with the table
// of that probe slot, score = sum_j lut[q][p][j][code_j], and returns the K'
// nearest as ascending (distance, packed location block*T + offset).  Two
// rows that share all M codes tie exactly; the packed key breaks the tie by
// location, as the reference's two-key sort does.
//
// What bounds it on an H100: bytes.  The function must read the M code
// bytes of the occupied, live rows of every member block, the ids and live
// bytes of every block some query probes (T * 5 bytes each), the tables
// (Q*NP*M*256*4 bytes), the probes, the candidate list and the output: at
// the DSSM deployment (Q 64, NP 32, M 16, T 1024, about 2500 candidate
// blocks, slots about 58% occupied) about 70 MB, 0.021 ms at 3.35 TB/s
// (chip_smoke.py counts it from the run's inputs); the adds are a few tens
// of millions.
//
// Design, the scheme of ivf_block_topk_int8.cu with tables in place of query
// rows, in three launches; what each step does about a cost of the first
// design (a grid of query x chunk of candidates, each block walking its
// whole chunk):
// * list_members (topk_common.cuh), one block per query: the query's
//   member candidates with each one's probe slot p (probe[q][p] == owner),
//   listed once by warp ballots.  The first design compared every owner
//   with all NP probes in every block of the grid, and its chunks held
//   uneven numbers of members.
// * Pass 1, grid (query, split): a query's members are cut evenly across its
//   S blocks.  A group is a run of consecutive members of one slot (at most
//   `grp` blocks), and its [M, 256] table (16 KB at M = 16) is staged once
//   by 16-byte cp.async into a ring of `nt` tables in shared memory: with
//   two, the next group's table (and its block ids) load while this group is
//   listed and scored.  The first design reloaded the table with plain loads
//   behind a barrier.  (Where no table fits beside the keys, nt = 0 and rows
//   gather from the table in device memory.)  The occupied, live slots of
//   the group's blocks are listed by warp ballots, and only their code rows
//   are copied, in tiles of R rows through a ring of ns tiles, the next
//   tiles loading while one is scored: by 16-byte cp.async where M is a
//   multiple of 16 and the pool 16-byte aligned, else by 4-byte or 1-byte
//   loads.  The first design tested all T slots, empty ones included, and
//   read each row a byte at a time.  One thread scores one row: its M
//   entries gathered from the staged table and added in the order
//   j = 0..M-1 with __fadd_rn, the TPU kernel's order and the plain
//   version's, so the two agree bit for bit; the gather's bank conflicts
//   (the codes of 32 rows spread over 32 banks) are the price of that order.
//   A key enters a candidate area only below the running K'-th best, and
//   the area is merged into the top-K' whenever it holds K'/2 keys (or a
//   tile could overflow it): sorted in runs of 32 by warps, each key placed at
//   its rank (merge_area), so the threshold tightens as the scan goes.  The
//   first design ran a bitonic sort of K' + T = 2048 keys, 66 stages behind
//   a barrier each, for every member block.  The split's sorted K' best go to
//   a partial buffer [Q, S, K'].
// * Pass 2 (merge_sorted_partials) ranks the S sorted runs of a query and
//   writes the first K' (one split: merge_partials sorts its run).
// Keys are unique per slot, so neither the order of the members nor that of
// the rows changes the result: exact ties come back in location order.  The
// TPU kernel selects the table and gathers its entries by a one-hot MXU
// contraction, for want of a per-lane gather; Hopper gathers from shared
// memory directly, so neither is carried over.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKsub = 256;
constexpr int kLoads = 8;  // slots a thread tests at once when listing
// Blocks an SM holds by shared memory at the DSSM deployment
// (kernels/BUDGETS.md), the launch bound's minimum: a cap of 64 registers.
// With no minimum ptxas aims at 5 blocks for 5 of the 6 instantiations (48
// registers) and spills long-lived scalars (the split's member range, the
// staging steps) that the group and tile loops reload.
constexpr int kMinBlocks = 4;

// UB: bytes a code unit is staged and read by (16: cp.async, M % 16 == 0
// and a 16-byte aligned pool; 4: M % 4 == 0 and 4-byte aligned; 1).
// kStaged: the tables are staged in shared memory (nt >= 1), else gathered
// from device memory.
template <int UB, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pq_topk_pass1(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              int T_m, int M, const int* __restrict__ block_ids,
              const int* __restrict__ members, const int* __restrict__ mslots,
              const int* __restrict__ counts, int C, int NP,
              const int* __restrict__ pool_ids,
              const uint8_t* __restrict__ pool_live, int K, int R, int L,
              int grp, int seg, int ns, int nt,
              unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TB = M * kKsub;  // floats a table
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [seg]
  float* tables = reinterpret_cast<float*>(keys + seg);        // [nt][TB]
  uint8_t* stage = reinterpret_cast<uint8_t*>(tables + static_cast<size_t>(nt) * TB);
  const int stage_bytes = (ns * R * M + 15) & ~15;              // [ns][R][M]
  int* list = reinterpret_cast<int*>(stage + stage_bytes);     // [L] slots
  int* gblk = list + L;                                        // [grp] blocks
  __shared__ int cnt, n_list;          // keys in the area; slots in the list
  __shared__ unsigned long long thr;   // the K'-th best so far

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int n_mem = counts[qi];
  const int m0 = static_cast<int>(static_cast<long long>(n_mem) * s / S);
  const int m1 = static_cast<int>(static_cast<long long>(n_mem) * (s + 1) / S);
  const int* mem = members + static_cast<size_t>(qi) * C;
  const int* msl = mslots + static_cast<size_t>(qi) * C;
  const float* lut_q = lut + static_cast<size_t>(qi) * NP * TB;
  const int CB = seg - K;  // candidate area, >= R

  for (int i = tid; i < seg; i += kThreads) keys[i] = EMPTY_KEY;
  if (tid == 0) {
    cnt = 0;
    thr = EMPTY_KEY;
  }

  auto stage_table = [&](int slot, int b) {
    const float* src = lut_q + static_cast<size_t>(slot) * TB;
    float* dst = tables + static_cast<size_t>(b) * TB;
    for (int x = tid; x < TB / 4; x += kThreads) cp_async16(dst + 4 * x, src + 4 * x);
  };
  // the end of the group starting at member mi: a run of one probe slot
  auto group_end = [&](int mi) {
    int me = mi + 1;
    while (me < m1 && me - mi < grp && msl[me] == msl[mi]) ++me;
    return me;
  };

  const int NU = M / UB;  // units a row
  const int r_first = tid / NU, u_first = tid % NU;
  const int r_step = kThreads / NU, u_step = kThreads % NU;
  auto stage_tile = [&](int i, int buf, int n) {
    const int rows = min(R, n - i * R);
    uint8_t* dst = stage + static_cast<size_t>(buf) * R * M;
    const int* slots = list + i * R;
    int r = r_first, u = u_first;
    for (int x = tid; x < rows * NU; x += kThreads) {
      const uint8_t* src = codes + static_cast<size_t>(slots[r]) * M;
      if constexpr (UB == 16)
        cp_async16(dst + r * M + u * 16, src + u * 16);
      else if constexpr (UB == 4)
        reinterpret_cast<uint32_t*>(dst + r * M)[u] =
            reinterpret_cast<const uint32_t*>(src)[u];
      else
        dst[r * M + u] = src[u];
      r += r_step;
      u += u_step;
      if (u >= NU) {
        u -= NU;
        ++r;
      }
    }
  };

  if constexpr (kStaged) {
    if (m0 < m1) stage_table(msl[m0], 0);
    cp_async_commit();
  }
  // thread j < grp holds the block id of member mi + j of the group to come
  int blk = tid < grp && m0 + tid < m1 ? max(block_ids[mem[m0 + tid]], 0) : 0;
  int cb = 0;  // the table buffer of the current group
  for (int mi = m0; mi < m1;) {
    const int me = group_end(mi);
    const int slot = msl[mi];
    if (tid < me - mi) gblk[tid] = blk;
    // the next group's block ids load while this group is listed and scored
    blk = tid < grp && me + tid < m1 ? max(block_ids[mem[me + tid]], 0) : 0;
    int nb = cb;  // the next group's buffer
    const float* tb;
    if constexpr (kStaged) {
      if (nt == 1) {  // the buffer is free since the last group's barrier
        if (mi > m0 && slot != msl[mi - 1]) stage_table(slot, 0);
        cp_async_commit();
      } else if (me < m1) {  // prefetch the next group's table, read after
        if (msl[me] != slot) {  // this group's last barrier
          nb = 1 - cb;
          stage_table(msl[me], nb);
        }
        cp_async_commit();
      }
      tb = tables + static_cast<size_t>(cb) * TB;
    } else {
      tb = lut_q + static_cast<size_t>(slot) * TB;
    }
    const int ng = me - mi;
    if (tid == 0) n_list = 0;
    __syncthreads();
    // the occupied, live slots of the group's blocks
    list_live_slots<kLoads>(gblk, ng, T_m, pool_ids, pool_live, &n_list,
                            [&](int at, int sl, int) { list[at] = sl; });
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
      // tile i and, committed before it, this group's table have landed
      // (this thread's copies)
      cp_async_wait(ns - 1);
      // the area's count is stable here: its last change came before the
      // barrier that ended the previous tile.  Merge where the tile could
      // overflow the area, and whenever it holds K / 2 keys: each merge
      // tightens the threshold, and a merge by rank costs a few barriers
      const bool full = cnt > CB - R || cnt >= (K + 1) / 2;
      __syncthreads();
      if (full) merge_area(keys, seg, K, &cnt, &thr);
      const uint8_t* rows = stage + static_cast<size_t>(i % ns) * R * M;
      const int r_base = i * R, nr = min(R, n - r_base);
      const unsigned long long th = thr;
      for (int r = tid; r < nr; r += kThreads) {
        const uint8_t* row = rows + static_cast<size_t>(r) * M;
        float acc = 0.f;  // j = 0..M-1, one rounding each, as the plain version
        if constexpr (UB == 16) {
          for (int u = 0; u < NU; ++u) {
            const uint4 v = reinterpret_cast<const uint4*>(row)[u];
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            const float* t = tb + u * 16 * kKsub;
#pragma unroll
            for (int b = 0; b < 16; ++b)
              acc = __fadd_rn(acc, t[b * kKsub + ((w[b >> 2] >> (8 * (b & 3))) & 255)]);
          }
        } else if constexpr (UB == 4) {
          for (int u = 0; u < NU; ++u) {
            const uint32_t w = reinterpret_cast<const uint32_t*>(row)[u];
            const float* t = tb + u * 4 * kKsub;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc = __fadd_rn(acc, t[b * kKsub + ((w >> (8 * b)) & 255)]);
          }
        } else {
          for (int j = 0; j < M; ++j) acc = __fadd_rn(acc, tb[j * kKsub + row[j]]);
        }
        const unsigned long long key = make_key(acc, list[r_base + r]);
        if (key < th) keys[K + atomicAdd(&cnt, 1)] = key;
      }
      __syncthreads();  // the tile's buffer and the area are settled
    }
    cp_async_wait(0);
    __syncthreads();  // the group's list, rows and table are read
    mi = me;
    cb = nb;
  }
  __syncthreads();
  merge_area(keys, seg, K, &cnt, &thr);
  unsigned long long* out = partial + (static_cast<size_t>(qi) * S + s) * K;
  for (int i = tid; i < K; i += kThreads) out[i] = keys[i];
}

template <int UB, bool kStaged>
int launch_pass1(const float* lut, const uint8_t* codes, int T_m, int M,
                 const int* block_ids, const int* members, const int* mslots,
                 const int* counts, int C, int S, const int* pool_ids,
                 const uint8_t* pool_live, int Q, int NP, int K, int R, int L,
                 int grp, int seg, int ns, int nt, unsigned long long* partial,
                 cudaStream_t st) {
  const size_t smem = static_cast<size_t>(seg) * sizeof(unsigned long long) +
                      static_cast<size_t>(nt) * M * kKsub * sizeof(float) +
                      ((static_cast<size_t>(ns) * R * M + 15) & ~size_t{15}) +
                      static_cast<size_t>(L + grp) * sizeof(int);
  const cudaError_t err = allow_smem(pq_topk_pass1<UB, kStaged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pq_topk_pass1<UB, kStaged><<<dim3(Q, S), kThreads, smem, st>>>(
      lut, codes, T_m, M, block_ids, members, mslots, counts, C, NP, pool_ids,
      pool_live, K, R, L, grp, seg, ns, nt, partial);
  return static_cast<int>(cudaGetLastError());
}

template <int UB>
int launch_pass1_ub(int nt, const float* lut, const uint8_t* codes, int T_m,
                    int M, const int* block_ids, const int* members,
                    const int* mslots, const int* counts, int C, int S,
                    const int* pool_ids, const uint8_t* pool_live, int Q, int NP,
                    int K, int R, int L, int grp, int seg, int ns,
                    unsigned long long* partial, cudaStream_t st) {
  return nt > 0
      ? launch_pass1<UB, true>(lut, codes, T_m, M, block_ids, members, mslots,
                               counts, C, S, pool_ids, pool_live, Q, NP, K, R,
                               L, grp, seg, ns, nt, partial, st)
      : launch_pass1<UB, false>(lut, codes, T_m, M, block_ids, members, mslots,
                                counts, C, S, pool_ids, pool_live, Q, NP, K, R,
                                L, grp, seg, ns, 0, partial, st);
}

}  // namespace

// lut [Q, NP, M, 256] f32 (16-byte aligned); codes [P, T_m, M] u8;
// block_ids, owners [C] i32; pool_ids [P, T_m] i32; pool_live [P, T_m] u8;
// probe [Q, NP] i32 -> out_d [Q, K] f32, out_i [Q, K] i32.  Scratch:
// members and mslots [Q, C] i32, counts [Q] i32, partial [Q, S, K] u64.
// Each query's members are cut into S splits and taken in groups of one
// probe slot of at most grp blocks (grp * T_m <= L); nt (0..2) tables are
// staged; rows are staged in tiles of R, ns (1..4) tiles in a ring; seg (a
// power of two >= K + R) keys hold the top-K and the candidate area.  ub
// (16, 4 or 1): the bytes a code unit is staged by; M is a multiple of it
// and the pool aligned to it.
extern "C" int ivf_pq_block_topk(const float* lut, const uint8_t* codes,
                                 int T_m, int M, const int* block_ids,
                                 const int* owners, int C, int S,
                                 const int* pool_ids, const uint8_t* pool_live,
                                 const int* probe, int Q, int NP, int K, int R,
                                 int L, int grp, int seg, int ns, int nt, int ub,
                                 int* members, int* mslots, int* counts,
                                 unsigned long long* partial, float* out_d,
                                 int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_list_members(owners, C, probe, Q, NP, members, mslots, counts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc;
  if (ub == 16)
    rc = launch_pass1_ub<16>(nt, lut, codes, T_m, M, block_ids, members, mslots,
                             counts, C, S, pool_ids, pool_live, Q, NP, K, R, L,
                             grp, seg, ns, partial, st);
  else if (ub == 4)
    rc = launch_pass1_ub<4>(nt, lut, codes, T_m, M, block_ids, members, mslots,
                            counts, C, S, pool_ids, pool_live, Q, NP, K, R, L,
                            grp, seg, ns, partial, st);
  else
    rc = launch_pass1_ub<1>(nt, lut, codes, T_m, M, block_ids, members, mslots,
                            counts, C, S, pool_ids, pool_live, Q, NP, K, R, L,
                            grp, seg, ns, partial, st);
  if (rc != 0) return rc;
  if (S == 1) return launch_merge(partial, Q, S, K, out_d, out_i, st);
  return launch_merge_sorted(partial, Q, S, K, out_d, out_i, st);
}
