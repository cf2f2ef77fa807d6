// PQ asymmetric-distance (ADC) sums: out[r][n] = sum_j lut[r][j][codes[r][n][j]].
//
// Replaces the TPU kernel `_adc_kernel` / `pq_adc` in
// src/repro/kernels/pq_adc.py (body at :26, pallas_call at :63).  The TPU
// has no per-lane gather from VMEM, so that kernel expands every code column
// to a one-hot [T, 256] tile and contracts it with the LUT row on the MXU.
// Hopper gathers from shared memory at full speed, so this kernel keeps the
// row's LUT there and gathers one entry per code byte, as GPU IVFPQ
// implementations do (the reference's own note, pq_adc.py:3).
//
// What bounds it on an H100: bytes.  The function reads R*N*M code bytes and
// R*M*256*4 table bytes and writes R*N*4 bytes of sums; the R*N*M float adds
// are far below the float32 rate.  On the block_table path of the DSSM
// deployment (R = 64 queries x 32 probes = 2048, N = 2048, M = 16) that is
// 117 MB, 0.035 ms at 3.35 TB/s; on chain_walk (N = 1024) 75 MB.  The table
// gathers are a second floor close below it: a warp's 32 gathers of one
// code column take about 3.1 shared-memory wavefronts (codes spread over
// the banks at random), about 0.026 ms for the block_table call.
//
// Design: the work is items (table r, chunk of rows), a run of consecutive
// items a block (pq_adc.plan_adc: as many blocks as the SMs hold at once,
// four an SM by registers, each with an equal run), so a block takes a
// table, or several in turn, and each thread a row at a time in batches of
// two (one for codes loaded a byte at a time). Per item, each thread issues
// its first batch's code loads (a row's 16 codes one 16-byte load where
// M % 16 == 0 and the codes 16-byte aligned; else 4- or 1-byte loads)
// before it waits on the table, which is staged by 16-byte cp.async
// (4-byte for a table off 16 bytes); the other blocks of the SM gather
// meanwhile. The next batch's codes load while the current
// batch is gathered. (On the H100, batches of four rows spilled registers
// and took 0.068 ms at block_table's shape, batches of two 0.049; a second
// table buffer prefetching the block's next table was no faster.) A row's M
// entries are added in the order j = 0..M-1 with __fadd_rn from 0, the order
// of the TPU kernel's accumulation and of the plain version (a loop over j),
// so the two agree bit for bit.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKsub = 256;
// rows a thread gathers at once: two, or one where a row's codes load a
// byte at a time (UB 1: two rows' 32 byte loads in flight spill at 64
// registers)
template <int UB>
constexpr int kBatch = UB == 1 ? 1 : 2;
constexpr int kMinBlocks = 4;   // blocks an SM holds (64 registers a thread)

// code bytes [16p, 16p + 16) of a row (those below M); UB: bytes a load
template <int UB>
__device__ __forceinline__ uint4 load_piece(const uint8_t* row, int p, int M) {
  if constexpr (UB == 16) {
    return __ldg(reinterpret_cast<const uint4*>(row) + p);
  } else if constexpr (UB == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + 4 * p;
    const int nw = min(4, M / 4 - 4 * p);
    uint4 v = make_uint4(__ldg(w), 0u, 0u, 0u);
    if (nw > 1) v.y = __ldg(w + 1);
    if (nw > 2) v.z = __ldg(w + 2);
    if (nw > 3) v.w = __ldg(w + 3);
    return v;
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const int nb = min(16, M - 16 * p);
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < nb) w[b >> 2] |= static_cast<uint32_t>(__ldg(row + 16 * p + b)) << (8 * (b & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// acc + the entries of a row's codes [16p, 16p + 16), j ascending
template <bool kFull>
__device__ __forceinline__ float gather_piece(float acc, const float* lut_s,
                                              const uint4& v, int p, int M) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const int nb = kFull ? 16 : min(16, M - 16 * p);
  const float* t = lut_s + 16 * p * kKsub;
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (kFull || b < nb)
      acc = __fadd_rn(acc, t[b * kKsub + ((w[b >> 2] >> (8 * (b & 3))) & 0xffu)]);
  return acc;
}

// UB: bytes a code load (16, 4, 1); kFull: M % 16 == 0
template <int UB, bool kFull>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              int R, int N, int M, int lut16, int nc, int rpc, int ipb,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float lut_s[];  // [M * 256]
  const int TB = M * kKsub;
  const int tid = threadIdx.x;
  const int it0 = blockIdx.x * ipb;
  const int it1 = min(R * nc, it0 + ipb);
  const int np = (M + 15) / 16;  // pieces of 16 codes a row

  int cur_r = -1;
  for (int it = it0; it < it1; ++it) {
    const int r = it / nc;
    const int n0 = (it - r * nc) * rpc, n1 = min(N, n0 + rpc);
    const uint8_t* base = codes + static_cast<size_t>(r) * N * M;
    // this thread's rows n0 + tid + 256 i, in batches of kBatch<UB>
    const int mine = n0 + tid < n1 ? (n1 - n0 - tid + kThreads - 1) / kThreads : 0;
    const int nbatch = (mine + kBatch<UB> - 1) / kBatch<UB>;
    auto load = [&](int bt, int p, uint4* v) {
#pragma unroll
      for (int i = 0; i < kBatch<UB>; ++i) {
        const int n = n0 + tid + kThreads * (bt * kBatch<UB> + i);
        v[i] = n < n1 ? load_piece<UB>(base + static_cast<size_t>(n) * M, p, M)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    uint4 cur[kBatch<UB>], nxt[kBatch<UB>];
    if (nbatch > 0) load(0, 0, cur);  // the codes first, then the table

    if (r != cur_r) {  // a new table: stage it while the codes load
      if (cur_r >= 0) __syncthreads();  // every thread is done with the last
      const float* src = lut + static_cast<size_t>(r) * TB;
      if (lut16) {
        for (int x = tid; x < TB / 4; x += kThreads) cp_async16(lut_s + 4 * x, src + 4 * x);
      } else {
        for (int x = tid; x < TB; x += kThreads) cp_async4_zfill(lut_s + x, src + x, true);
      }
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
      cur_r = r;
    }

    // the next batch's codes load while this one is gathered
    float acc[kBatch<UB>];
#pragma unroll
    for (int i = 0; i < kBatch<UB>; ++i) acc[i] = 0.f;
    for (int bt = 0; bt < nbatch; ++bt) {
      for (int p = 0; p < np; ++p) {
        const bool last = p + 1 == np;
        if (!last) load(bt, p + 1, nxt);
        else if (bt + 1 < nbatch) load(bt + 1, 0, nxt);
#pragma unroll
        for (int i = 0; i < kBatch<UB>; ++i)
          acc[i] = gather_piece<kFull>(acc[i], lut_s, cur[i], p, M);
        if (last) {
#pragma unroll
          for (int i = 0; i < kBatch<UB>; ++i) {
            const int n = n0 + tid + kThreads * (bt * kBatch<UB> + i);
            if (n < n1) out[static_cast<size_t>(r) * N + n] = acc[i];
            acc[i] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch<UB>; ++i) cur[i] = nxt[i];
      }
    }
  }
}

template <int UB, bool kFull>
cudaError_t run(const float* lut, const uint8_t* codes, int R, int N, int M,
                int lut16, int nc, int rpc, int ipb, int grid, float* out,
                cudaStream_t st) {
  const size_t smem = static_cast<size_t>(M) * kKsub * sizeof(float);
  const cudaError_t err = allow_smem(pq_adc_kernel<UB, kFull>, smem);
  if (err != cudaSuccess) return err;
  pq_adc_kernel<UB, kFull><<<grid, kThreads, smem, st>>>(
      lut, codes, R, N, M, lut16, nc, rpc, ipb, out);
  return cudaGetLastError();
}

}  // namespace

// lut [R, M, 256] f32; codes [R, N, M] u8 -> out [R, N] f32.  ub: bytes a
// code load (16: M % 16 == 0 and codes 16-byte aligned; 4: M % 4 == 0 and
// 4-byte aligned; 1); lut16: the tables are 16-byte aligned; items (table,
// chunk of rpc rows), nc a table, ipb a block, `grid` blocks
// (pq_adc.plan_adc).  R, N > 0.
extern "C" int pq_adc_f32(const float* lut, const uint8_t* codes, int R, int N,
                          int M, int ub, int lut16, int nc, int rpc, int ipb,
                          int grid, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ub == 16)
    err = run<16, true>(lut, codes, R, N, M, lut16, nc, rpc, ipb, grid, out, st);
  else if (ub == 4)
    err = M % 16 == 0
              ? run<4, true>(lut, codes, R, N, M, lut16, nc, rpc, ipb, grid, out, st)
              : run<4, false>(lut, codes, R, N, M, lut16, nc, rpc, ipb, grid, out, st);
  else
    err = M % 16 == 0
              ? run<1, true>(lut, codes, R, N, M, lut16, nc, rpc, ipb, grid, out, st)
              : run<1, false>(lut, codes, R, N, M, lut16, nc, rpc, ipb, grid, out, st);
  return static_cast<int>(err);
}
