// Fused IVF block scan with a streaming top-K' over PQ code blocks (IVFPQ).
//
// Replaces the TPU kernel `_pq_topk_kernel` / `ivf_pq_block_topk` in
// src/repro/kernels/ivf_scan.py (body at :892, pallas_call at :1025).  Pool
// rows are uint8 PQ codes [T, M] of residuals against their cluster's
// centroid; queries arrive as one ADC table per (query, probe) pair, lut
// [Q, NP, M, 256].  For every query it scores the rows of the candidate blocks
// whose owner is in the query's probe list with the table of that probe slot,
// score = sum_j lut[q][p][j][code_j], masks empty slots (id -1) and
// tombstones (live == 0), and returns the K' nearest as ascending (distance,
// packed location block*T + offset).  Two rows that share all M codes tie
// exactly; the packed key breaks the tie by location, as the reference's
// two-key sort does.
//
// What bounds it on an H100: bytes.  The function must read every candidate
// block once, C*T*(M + 4 + 1) bytes of codes, ids and live bits, and every
// (query, probe) table once, Q*NP*M*256*4 bytes.  At the DSSM deployment
// (about 2000 candidate blocks of 1024 x 16 codes, Q = 64, NP = 32) that is
// about 40 MB of blocks and 34 MB of tables, about 0.02 ms at 3.35 TB/s; the
// adds are a few tens of millions.
//
// Design, the split-C structure of ivf_block_topk_int8.cu:
// * Pass 1, grid (query, chunk of candidates).  A block finds, for each
//   candidate of its chunk, the probe slot p with probe[q][p] == owner (probe
//   ids are distinct, so at most one) and skips non-members before touching
//   the block.  For a member it stages only the [M, 256] table of (q, p) in
//   shared memory (16 KB at M = 16; all NP tables of a query, 512 KB at
//   NP = 32, would not fit), and keeps it while the next member needs the
//   same slot.  The TPU kernel's one-hot MXU contraction selects the table
//   and gathers the entries because the TPU has no per-lane gather; Hopper
//   gathers from shared memory directly, so neither is carried over.  One
//   thread per row reads the row's M code bytes and sums the M table entries
//   in the order j = 0..M-1 with plain float32 adds (the TPU kernel's order;
//   the plain version loops over j the same way, so the two agree bit for
//   bit).  The T keys are merged into the running top-K' in shared memory by
//   a bitonic sort of the K' + T keys; the chunk's K' best go to the partial
//   buffer [Q, S, K'].
// * Pass 2 (merge_partials in topk_common.cuh) sorts each query's S*K' keys.
// At the DSSM deployment a list holds about 250 rows, so most of a block's
// T = 1024 slots are empty and most of each sorted K' + T is (inf, -1): the
// sort per member block, not bytes, is what keeps this first design above
// its bound.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKsub = 256;

__global__ void __launch_bounds__(kThreads)
pq_topk_pass1(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              int T_m, int M, const int* __restrict__ block_ids,
              const int* __restrict__ owners, int C, int chunk,
              const int* __restrict__ pool_ids,
              const uint8_t* __restrict__ pool_live,
              const int* __restrict__ probe, int NP, int K, int nbuf,
              unsigned long long* __restrict__ partial) {
  extern __shared__ unsigned long long buf[];  // [nbuf] keys, nbuf >= K + T_m
  float* lut_s = reinterpret_cast<float*>(buf + nbuf);  // [M * 256]
  int* probes = reinterpret_cast<int*>(lut_s + M * kKsub);  // [NP]
  __shared__ int pslot[kThreads];

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int c0 = s * chunk;
  const int c1 = min(C, c0 + chunk);

  for (int p = threadIdx.x; p < NP; p += blockDim.x)
    probes[p] = probe[static_cast<size_t>(qi) * NP + p];
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x) buf[i] = EMPTY_KEY;
  __syncthreads();

  int staged = -1;  // probe slot whose table is in lut_s (uniform)
  for (int g = c0; g < c1; g += blockDim.x) {
    const int c = g + threadIdx.x;
    int ps = -1;
    if (c < c1) {
      const int own = owners[c];
      if (own >= 0)
        for (int p = 0; p < NP; ++p)
          if (probes[p] == own) ps = p;
    }
    pslot[threadIdx.x] = ps;
    __syncthreads();
    const int gn = min(static_cast<int>(blockDim.x), c1 - g);
    for (int j = 0; j < gn; ++j) {
      const int p = pslot[j];
      if (p < 0) continue;  // uniform over the block
      if (p != staged) {
        const float* src =
            lut + (static_cast<size_t>(qi) * NP + p) * M * kKsub;
        for (int i = threadIdx.x; i < M * kKsub; i += blockDim.x)
          lut_s[i] = src[i];
        staged = p;
        __syncthreads();
      }
      const int blk = max(block_ids[g + j], 0);
      for (int t = threadIdx.x; t < T_m; t += blockDim.x) {
        const int slot = blk * T_m + t;
        unsigned long long key = EMPTY_KEY;
        if (pool_ids[slot] != -1 && pool_live[slot] != 0) {
          const uint8_t* row = codes + static_cast<size_t>(slot) * M;
          float acc = 0.f;
          for (int m = 0; m < M; ++m)
            acc = __fadd_rn(acc, lut_s[m * kKsub + row[m]]);
          key = make_key(acc, slot);
        }
        buf[K + t] = key;
      }
      // keys past K + T_m are whatever the last sort left there; clear them
      for (int i = K + T_m + threadIdx.x; i < nbuf; i += blockDim.x)
        buf[i] = EMPTY_KEY;
      __syncthreads();
      bitonic_sort(buf, nbuf);  // also orders the next staging after the reads
    }
    __syncthreads();  // pslot[] is rewritten by the next group
  }

  unsigned long long* out = partial + (static_cast<size_t>(qi) * S + s) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) out[i] = buf[i];
}

}  // namespace

// lut [Q, NP, M, 256] f32; codes [P, T_m, M] u8; block_ids, owners [C] i32;
// pool_ids [P, T_m] i32; pool_live [P, T_m] u8; probe [Q, NP] i32; partial
// [Q, S, K] u64 scratch -> out_d [Q, K] f32, out_i [Q, K] i32.  The
// candidates are cut into S chunks of `chunk` (S * chunk >= C > 0).
extern "C" int ivf_pq_block_topk(const float* lut, const uint8_t* codes,
                                 int T_m, int M, const int* block_ids,
                                 const int* owners, int C, int chunk, int S,
                                 const int* pool_ids, const uint8_t* pool_live,
                                 const int* probe, int Q, int NP, int K,
                                 unsigned long long* partial, float* out_d,
                                 int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbuf = next_pow2(K + T_m);
  const size_t smem = nbuf * sizeof(unsigned long long) +
                      static_cast<size_t>(M) * kKsub * sizeof(float) +
                      static_cast<size_t>(NP) * sizeof(int);
  cudaError_t err = allow_smem(pq_topk_pass1, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pq_topk_pass1<<<dim3(Q, S), kThreads, smem, st>>>(
      lut, codes, T_m, M, block_ids, owners, C, chunk, pool_ids, pool_live,
      probe, NP, K, nbuf, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, Q, S, K, out_d, out_i, st);
}
