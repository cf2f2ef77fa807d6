// Fused IVF block scan with a streaming top-K' over int8 residual codes.
//
// Replaces the TPU kernel `_topk_int8_kernel` / `ivf_block_topk_int8` in
// src/repro/kernels/ivf_scan.py (body at :577, pallas_call at :714).  Pool
// rows are int8 codes of residuals against their cluster's centroid, with one
// float32 scale per row; queries arrive as one quantized residual per
// (query, probe) pair, q_codes [Q, NP, D] with q_meta [Q, NP, 2] = (scale,
// scale^2 * sum(code^2)).  For every query it scores the rows of the
// candidate blocks whose owner is in the query's probe list, against the
// residual of that probe slot:
//     score = (qn + (sv*sv)*cn) - 2*((sq*sv)*dot)
// with dot = sum(q_code * code) and cn = sum(code^2) exact in int32, masks
// empty slots and tombstones, and returns the K' nearest as ascending
// (distance, packed location block*T + offset).  Quantization makes exact
// ties (rows with equal codes and scale); the packed key breaks them by
// location, as the reference's two-key sort does.
//
// What bounds it on an H100: bytes.  The function must read every candidate
// block once: C*T*(D + 4 + 4 + 1) bytes of codes, scales, ids and live bits.
// With about 1600 blocks of 1024 x 128 that is about 220 MB, 0.065 ms at
// 3.35 TB/s; the integer dots are a few hundred million operations.
//
// Design, the split-C structure of ivf_block_topk.cu:
// * Pass 1, grid (query, chunk of candidates).  A block finds, for each
//   candidate of its chunk, the probe slot p with probe[q][p] == owner (probe
//   ids are distinct, so at most one) and skips non-members before touching
//   the candidate's rows.  For a member it stages only the matched row
//   q_codes[q][p] (D bytes, as D/4 packed words) and its meta in shared
//   memory, not all NP rows: the TPU kernel's [Q_t, NP] one-hot selection is
//   a workaround for the TPU and is not carried over.  One warp per row takes
//   the dot and the norm with __dp4a over packed int8x4 words (coalesced
//   4-byte reads along D), sums them with an exact integer warp reduction,
//   and lane 0 forms the score with explicit round-to-nearest intrinsics, so
//   nvcc's default FMA contraction cannot move its last bit away from the
//   plain version's (an FMA would make or break exact ties).  The T keys are
//   merged into the running top-K' in shared memory by a bitonic sort of the
//   K' + T keys; the chunk's K' best go to the partial buffer [Q, S, K'].
// * Pass 2 (merge_partials in topk_common.cuh) sorts each query's S*K' keys.
// As in the float kernel, a member block is read once per query that probes
// it, and every member block pays a full sort; tensor-core s8 MMA over the
// queries that share a block, and a cheaper merge, are later work.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;

// The reference's epilogue, one rounding per operation, in its order.
__device__ __forceinline__ float int8_score(float qn, float sq, float sv,
                                            int cn, int dot) {
  const float vterm = __fmul_rn(__fmul_rn(sv, sv), __int2float_rn(cn));
  const float coef = __fmul_rn(sq, sv);
  return __fsub_rn(__fadd_rn(qn, vterm),
                   __fmul_rn(2.0f, __fmul_rn(coef, __int2float_rn(dot))));
}

__global__ void __launch_bounds__(kThreads)
int8_topk_pass1(const int8_t* __restrict__ q_codes,
                const float* __restrict__ q_meta,
                const int8_t* __restrict__ pool,
                const float* __restrict__ pool_scales, int T_m, int D,
                const int* __restrict__ block_ids,
                const int* __restrict__ owners, int C, int chunk,
                const int* __restrict__ pool_ids,
                const uint8_t* __restrict__ pool_live,
                const int* __restrict__ probe, int NP, int K, int nbuf,
                unsigned long long* __restrict__ partial) {
  extern __shared__ unsigned long long buf[];  // [nbuf] keys, nbuf >= K + T_m
  const int W = D >> 2;                        // packed int8x4 words per row
  int* qw = reinterpret_cast<int*>(buf + nbuf);  // [W] staged query codes
  int* probes = qw + W;                          // [NP]
  __shared__ int pslot[kThreads];
  __shared__ float sq_s, qn_s;

  const int qi = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = s * chunk;
  const int c1 = min(C, c0 + chunk);

  for (int p = threadIdx.x; p < NP; p += blockDim.x)
    probes[p] = probe[static_cast<size_t>(qi) * NP + p];
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x) buf[i] = EMPTY_KEY;
  __syncthreads();

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
      const size_t row_q = static_cast<size_t>(qi) * NP + p;
      const int* src = reinterpret_cast<const int*>(q_codes + row_q * D);
      for (int w = threadIdx.x; w < W; w += blockDim.x) qw[w] = src[w];
      if (threadIdx.x == 0) {
        sq_s = q_meta[row_q * 2];
        qn_s = q_meta[row_q * 2 + 1];
      }
      __syncthreads();
      const float sq = sq_s, qn = qn_s;
      const int blk = max(block_ids[g + j], 0);
      const int* rows =
          reinterpret_cast<const int*>(pool + static_cast<size_t>(blk) * T_m * D);
      for (int t = warp; t < T_m; t += nwarps) {
        const int* row = rows + static_cast<size_t>(t) * W;
        int dot = 0, cn = 0;
        for (int w = lane; w < W; w += 32) {
          const int v = row[w];
          dot = __dp4a(v, qw[w], dot);
          cn = __dp4a(v, v, cn);
        }
        dot = __reduce_add_sync(0xffffffffu, dot);
        cn = __reduce_add_sync(0xffffffffu, cn);
        if (lane == 0) {
          const int slot = blk * T_m + t;
          const bool ok = pool_ids[slot] != -1 && pool_live[slot] != 0;
          buf[K + t] = ok ? make_key(int8_score(qn, sq, pool_scales[slot], cn, dot),
                                     slot)
                          : EMPTY_KEY;
        }
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

// q_codes [Q, NP, D] i8; q_meta [Q, NP, 2] f32; pool [P, T_m, D] i8;
// pool_scales [P, T_m] f32; block_ids, owners [C] i32; pool_ids [P, T_m] i32;
// pool_live [P, T_m] u8; probe [Q, NP] i32; partial [Q, S, K] u64 scratch;
// -> out_d [Q, K] f32, out_i [Q, K] i32.  D is a multiple of 4 and the code
// tensors are 4-byte aligned.  The candidates are cut into S chunks of
// `chunk` (S * chunk >= C > 0).
extern "C" int ivf_block_topk_int8(const int8_t* q_codes, const float* q_meta,
                                   const int8_t* pool, const float* pool_scales,
                                   int T_m, int D, const int* block_ids,
                                   const int* owners, int C, int chunk, int S,
                                   const int* pool_ids, const uint8_t* pool_live,
                                   const int* probe, int Q, int NP, int K,
                                   unsigned long long* partial, float* out_d,
                                   int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbuf = next_pow2(K + T_m);
  const size_t smem = nbuf * sizeof(unsigned long long) +
                      static_cast<size_t>(D / 4 + NP) * sizeof(int);
  cudaError_t err = allow_smem(int8_topk_pass1, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_topk_pass1<<<dim3(Q, S), kThreads, smem, st>>>(
      q_codes, q_meta, pool, pool_scales, T_m, D, block_ids, owners, C, chunk,
      pool_ids, pool_live, probe, NP, K, nbuf, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, Q, S, K, out_d, out_i, st);
}
