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
// R*M*256*4 LUT bytes and writes R*N*4 bytes of sums; the R*N*M float adds
// are far below the float32 rate.  On the block_table path of the DSSM
// deployment (R = 64 queries x 32 probes, N = chain * 1024, M = 16) that is
// about 70 MB per chain block, about 0.02 ms at 3.35 TB/s.
//
// Design: grid (row r, tile of 2048 code rows).  A block stages the row's
// [M, 256] LUT in shared memory (16 KB at M = 16) and each thread takes one
// code row at a time, doing M gathers; the tile is large enough that the LUT
// is read about once per row r, not once per code row.  The M entries are
// summed in the order j = 0..M-1 with plain float32 adds, the order of the
// TPU kernel's accumulation, so the plain version (a loop over j) gives the
// same bits.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKsub = 256;
constexpr int kTile = 2048;  // code rows per block

__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              int N, int M, float* __restrict__ out) {
  extern __shared__ float lut_s[];  // [M * 256]
  const int r = blockIdx.x;
  const float* src = lut + static_cast<size_t>(r) * M * kKsub;
  for (int i = threadIdx.x; i < M * kKsub; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();
  const int n1 = min(N, (blockIdx.y + 1) * kTile);
  for (int n = blockIdx.y * kTile + threadIdx.x; n < n1; n += blockDim.x) {
    const uint8_t* row = codes + (static_cast<size_t>(r) * N + n) * M;
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc = __fadd_rn(acc, lut_s[j * kKsub + row[j]]);
    out[static_cast<size_t>(r) * N + n] = acc;
  }
}

}  // namespace

// lut [R, M, 256] f32; codes [R, N, M] u8 -> out [R, N] f32.  R, N > 0 and
// N <= 65535 * 2048 (the grid's y extent).
extern "C" int pq_adc_f32(const float* lut, const uint8_t* codes, int R, int N,
                          int M, float* out, void* stream) {
  const size_t smem = static_cast<size_t>(M) * kKsub * sizeof(float);
  cudaError_t err = allow_smem(pq_adc_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(R, (N + kTile - 1) / kTile);
  pq_adc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut, codes, N, M, out);
  return static_cast<int>(cudaGetLastError());
}
