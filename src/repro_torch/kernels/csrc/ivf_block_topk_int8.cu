// Fused IVF block scan with a streaming top-K' over int8 residual codes.
//
// Replaces the TPU kernel `_topk_int8_kernel` / `ivf_block_topk_int8` in
// src/repro/kernels/ivf_scan.py (body at :577, pallas_call at :714).  Pool
// rows are int8 codes of residuals against their cluster's centroid, with one
// float32 scale per row; queries arrive as one quantized residual per
// (query, probe) pair, q_codes [Q, NP, D] with q_meta [Q, NP, 2] = (scale,
// scale^2 * sum(code^2)).  For every query it scores the occupied, live rows
// of the candidate blocks whose owner is in the query's probe list, against
// the residual of that probe slot:
//     score = (qn + (sv*sv)*cn) - 2*((sq*sv)*dot)
// with dot = sum(q_code * code) and cn = sum(code^2) exact in int32, and
// returns the K' nearest as ascending (distance, packed location
// block*T + offset).  Quantization makes exact ties (rows with equal codes
// and scale); the packed key breaks them by location, as the reference's
// two-key sort does.
//
// What bounds it on an H100: bytes.  The function must read the codes and
// scales of the occupied, live slots of the candidate blocks once, and the
// ids and live bytes of every block some query probes: at SIFT1M (about 1570
// blocks of 1024 slots, about 26% occupied, D = 128) about 65 MB, 0.019 ms
// at 3.35 TB/s; the integer dots are a few hundred million operations.
//
// Design, the scheme of ivf_block_topk.cu, in three launches:
// * list_members (topk_common.cuh), one block per query: the query's member
//   candidates in candidate order by warp ballots, with each member's probe
//   slot p (probe[q][p] == owner).  Blocks that walked chunks of
//   candidates instead would get anywhere from 0 to a dozen members each.
// * Pass 1, grid (query, split): a query's members are cut evenly across its
//   S blocks, and taken in groups of `grp` blocks.  For a group the block
//   stages the matched query rows q_codes[q][p] (D bytes each) and their
//   meta once, lists the occupied, live slots of the group's blocks by warp
//   ballots (with each slot's member and scale), and copies only their code
//   rows, by 16-byte cp.async, in tiles of R rows through a ring of ns tiles
//   in shared memory, the next tiles loading while this one is scored (rows
//   whose D bytes are not a multiple of 16, or a pool not 16-byte aligned,
//   are staged by plain 4-byte loads).  Eight lanes score a row: __dp4a over
//   16 bytes each for the dot and the norm, three exact integer shuffles,
//   then the epilogue with explicit round-to-nearest intrinsics in the
//   reference's order (an FMA would make or break exact ties).  A key enters
//   a candidate area only below the running K'-th best, and the area is
//   sorted with the top-K' only when a tile could overflow it, and once at
//   the end (merge_area), where a sort of K' + T keys per member block
//   would cost more than its rows.  The split's sorted K' best go to
//   a partial buffer [Q, S, K'].
// * Pass 2 (merge_sorted_partials) ranks the S sorted runs of a query and
//   writes the first K'.
// Keys are unique per slot, so the order in which rows are scored does not
// change the result: exact ties come back in location order.  One query
// meets each staged row, so s8 mma would multiply mostly zeros; __dp4a on
// the CUDA cores does the same integer sums.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;  // lanes scoring one row
constexpr int kRowsPerPass = kThreads / kRowThreads;
constexpr int kLoads = 8;  // slots a thread tests at once when listing
// The launch bound's minimum of blocks an SM: 5, as shared memory holds at
// SIFT1M (kernels/BUDGETS.md), a cap of 48 registers; rows off 16 bytes
// (kVec false) spill under that cap and take 4 (64 registers), a cap under
// which <true> spills.  With no minimum ptxas gives both 48 registers and
// spills long-lived scalars (the split's member range, the staging steps)
// that the group and tile loops reload.
template <bool kVec>
constexpr int kMinBlocks = kVec ? 5 : 4;

// The reference's epilogue, one rounding per operation, in its order.
__device__ __forceinline__ float int8_score(float qn, float sq, float sv,
                                            int cn, int dot) {
  const float vterm = __fmul_rn(__fmul_rn(sv, sv), __int2float_rn(cn));
  const float coef = __fmul_rn(sq, sv);
  return __fsub_rn(__fadd_rn(qn, vterm),
                   __fmul_rn(2.0f, __fmul_rn(coef, __int2float_rn(dot))));
}

// kVec: D is a multiple of 16 and the pool 16-byte aligned, so rows are
// staged by cp.async and scored in 16-byte units; else in 4-byte words.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kVec>)
int8_topk_pass1(const int8_t* __restrict__ q_codes,
                const float* __restrict__ q_meta,
                const int8_t* __restrict__ pool,
                const float* __restrict__ pool_scales, int T_m, int D,
                const int* __restrict__ block_ids,
                const int* __restrict__ members, const int* __restrict__ mslots,
                const int* __restrict__ counts, int C, int NP,
                const int* __restrict__ pool_ids,
                const uint8_t* __restrict__ pool_live, int K, int R, int L,
                int grp, int seg, int ns, unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dq = (D + 15) & ~15;  // a staged query row, 16-byte aligned
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [seg]
  int8_t* qs = reinterpret_cast<int8_t*>(keys + seg);          // [grp][Dq]
  int8_t* stage = qs + static_cast<size_t>(grp) * Dq;          // [ns][R][D]
  float* lscale = reinterpret_cast<float*>(stage + static_cast<size_t>(ns) * R * D);  // [L]
  int* list = reinterpret_cast<int*>(lscale + L);              // [L] slots
  float* qmeta = reinterpret_cast<float*>(list + L);           // [grp][2]
  int* gblk = reinterpret_cast<int*>(qmeta + 2 * grp);         // [grp]
  uint16_t* lmem = reinterpret_cast<uint16_t*>(gblk + grp);    // [L] member
  __shared__ int cnt, n_list;          // keys in the area; slots in the list
  __shared__ unsigned long long thr;   // the K'-th best so far

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int n_mem = counts[qi];
  const int m0 = static_cast<int>(static_cast<long long>(n_mem) * s / S);
  const int m1 = static_cast<int>(static_cast<long long>(n_mem) * (s + 1) / S);
  const int* mem = members + static_cast<size_t>(qi) * C;
  const int* msl = mslots + static_cast<size_t>(qi) * C;
  const int CB = seg - K;  // candidate area, >= 2R

  for (int i = tid; i < seg; i += kThreads) keys[i] = EMPTY_KEY;
  if (tid == 0) {
    cnt = 0;
    thr = EMPTY_KEY;
  }

  constexpr int UB = kVec ? 16 : 4;  // bytes a unit
  const int NU = D / UB;             // units a row
  const int W = D >> 2;              // 4-byte words a query row
  const int sub = tid % kRowThreads, rr = tid / kRowThreads;

  // a thread's (row, unit) in a tile, stepped by kThreads units without a
  // division
  const int r_first = tid / NU, u_first = tid % NU;
  const int r_step = kThreads / NU, u_step = kThreads % NU;
  auto stage_tile = [&](int i, int buf, int n) {
    const int rows = min(R, n - i * R);
    int8_t* dst = stage + static_cast<size_t>(buf) * R * D;
    const int* slots = list + i * R;
    int r = r_first, u = u_first;
    for (int x = tid; x < rows * NU; x += kThreads) {
      const int8_t* src = pool + static_cast<size_t>(slots[r]) * D;
      if constexpr (kVec)
        cp_async16(dst + r * D + u * 16, src + u * 16);
      else
        reinterpret_cast<int*>(dst + r * D)[u] = reinterpret_cast<const int*>(src)[u];
      r += r_step;
      u += u_step;
      if (u >= NU) {
        u -= NU;
        ++r;
      }
    }
  };

  for (int mi = m0; mi < m1; mi += grp) {
    // the group's blocks, its matched query rows and their meta
    const int ng = min(m1 - mi, grp);
    for (int j = tid; j < ng; j += kThreads) {
      gblk[j] = max(block_ids[mem[mi + j]], 0);
      const size_t row_q = static_cast<size_t>(qi) * NP + msl[mi + j];
      qmeta[2 * j] = q_meta[row_q * 2];          // scale
      qmeta[2 * j + 1] = q_meta[row_q * 2 + 1];  // reconstructed norm
    }
    for (int x = tid; x < ng * W; x += kThreads) {
      const int j = x / W, w = x - j * W;
      const size_t row_q = static_cast<size_t>(qi) * NP + msl[mi + j];
      reinterpret_cast<int*>(qs + j * Dq)[w] =
          reinterpret_cast<const int*>(q_codes + row_q * D)[w];
    }
    if (tid == 0) n_list = 0;
    __syncthreads();
    // the occupied, live slots of the group's blocks, with member and scale
    list_live_slots<kLoads>(gblk, ng, T_m, pool_ids, pool_live, &n_list,
                            [&](int at, int slot, int j) {
                              list[at] = slot;
                              lmem[at] = static_cast<uint16_t>(j);
                              lscale[at] = pool_scales[slot];
                            });
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
      const int8_t* rows = stage + static_cast<size_t>(i % ns) * R * D;
      const int r_base = i * R, nr = min(R, n - r_base);
      const unsigned long long th = thr;
      for (int r0 = 0; r0 < nr; r0 += kRowsPerPass) {  // uniform over the block
        const int r = r0 + rr;
        int dot = 0, cn = 0, j = 0;
        if (r < nr) {
          j = lmem[r_base + r];
          const int8_t* row = rows + static_cast<size_t>(r) * D;
          const int8_t* qrow = qs + j * Dq;
          for (int u = sub; u < NU; u += kRowThreads) {
            if constexpr (kVec) {
              const int4 v = reinterpret_cast<const int4*>(row)[u];
              const int4 qv = reinterpret_cast<const int4*>(qrow)[u];
              dot = __dp4a(v.x, qv.x, dot);
              dot = __dp4a(v.y, qv.y, dot);
              dot = __dp4a(v.z, qv.z, dot);
              dot = __dp4a(v.w, qv.w, dot);
              cn = __dp4a(v.x, v.x, cn);
              cn = __dp4a(v.y, v.y, cn);
              cn = __dp4a(v.z, v.z, cn);
              cn = __dp4a(v.w, v.w, cn);
            } else {
              const int v = reinterpret_cast<const int*>(row)[u];
              dot = __dp4a(v, reinterpret_cast<const int*>(qrow)[u], dot);
              cn = __dp4a(v, v, cn);
            }
          }
        }
#pragma unroll
        for (int o = kRowThreads / 2; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
          cn += __shfl_xor_sync(0xffffffffu, cn, o);
        }
        if (sub == 0 && r < nr) {
          const float score = int8_score(qmeta[2 * j + 1], qmeta[2 * j],
                                         lscale[r_base + r], cn, dot);
          const unsigned long long key = make_key(score, list[r_base + r]);
          if (key < th) keys[K + atomicAdd(&cnt, 1)] = key;
        }
      }
      __syncthreads();  // the tile's buffer and the area are settled
    }
    cp_async_wait(0);
    __syncthreads();  // the group's lists and rows are read: the next rewrites them
  }
  __syncthreads();
  merge_area(keys, seg, K, &cnt, &thr);
  unsigned long long* out = partial + (static_cast<size_t>(qi) * S + s) * K;
  for (int i = tid; i < K; i += kThreads) out[i] = keys[i];
}

template <bool kVec>
int launch_pass1(const int8_t* q_codes, const float* q_meta, const int8_t* pool,
                 const float* pool_scales, int T_m, int D, const int* block_ids,
                 const int* members, const int* mslots, const int* counts, int C,
                 int S, const int* pool_ids, const uint8_t* pool_live, int Q,
                 int NP, int K, int R, int L, int grp, int seg, int ns,
                 unsigned long long* partial, cudaStream_t st) {
  const size_t Dq = static_cast<size_t>((D + 15) & ~15);
  const size_t smem = static_cast<size_t>(seg) * sizeof(unsigned long long) +
                      grp * Dq + static_cast<size_t>(ns) * R * D +
                      static_cast<size_t>(L) * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(grp) * (2 * sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(L) * sizeof(uint16_t);
  const cudaError_t err = allow_smem(int8_topk_pass1<kVec>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_topk_pass1<kVec><<<dim3(Q, S), kThreads, smem, st>>>(
      q_codes, q_meta, pool, pool_scales, T_m, D, block_ids, members, mslots,
      counts, C, NP, pool_ids, pool_live, K, R, L, grp, seg, ns, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_codes [Q, NP, D] i8; q_meta [Q, NP, 2] f32; pool [P, T_m, D] i8;
// pool_scales [P, T_m] f32; block_ids, owners [C] i32; pool_ids [P, T_m] i32;
// pool_live [P, T_m] u8; probe [Q, NP] i32 -> out_d [Q, K] f32, out_i [Q, K]
// i32.  Scratch: members and mslots [Q, C] i32, counts [Q] i32, partial
// [Q, S, K] u64.  D is a multiple of 4 and the code tensors 4-byte aligned.
// Each query's members are cut into S splits and taken in groups of grp
// blocks (grp * T_m <= L); rows are staged in tiles of R, ns (2..4) tiles in
// a ring; seg (a power of two >= K + 2R) keys hold the top-K and the
// candidate area.  vec != 0: D is a multiple of 16 and the pool 16-byte
// aligned.
extern "C" int ivf_block_topk_int8(const int8_t* q_codes, const float* q_meta,
                                   const int8_t* pool, const float* pool_scales,
                                   int T_m, int D, const int* block_ids,
                                   const int* owners, int C, int S,
                                   const int* pool_ids, const uint8_t* pool_live,
                                   const int* probe, int Q, int NP, int K, int R,
                                   int L, int grp, int seg, int ns, int vec,
                                   int* members, int* mslots, int* counts,
                                   unsigned long long* partial, float* out_d,
                                   int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_list_members(owners, C, probe, Q, NP, members, mslots, counts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = vec
      ? launch_pass1<true>(q_codes, q_meta, pool, pool_scales, T_m, D, block_ids,
                           members, mslots, counts, C, S, pool_ids, pool_live, Q,
                           NP, K, R, L, grp, seg, ns, partial, st)
      : launch_pass1<false>(q_codes, q_meta, pool, pool_scales, T_m, D, block_ids,
                            members, mslots, counts, C, S, pool_ids, pool_live, Q,
                            NP, K, R, L, grp, seg, ns, partial, st);
  if (rc != 0) return rc;
  return launch_merge_sorted(partial, Q, S, K, out_d, out_i, st);
}
