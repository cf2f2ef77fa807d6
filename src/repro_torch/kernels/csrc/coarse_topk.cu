// Streaming coarse probe: the top-nprobe nearest centroids of every query.
//
// Replaces the TPU kernel `_coarse_kernel` / `coarse_topk` in
// src/repro/kernels/ivf_scan.py (pallas_call at :234), which streams
// centroid tiles through VMEM and merges them into a per-query top-nprobe
// accumulator.
//
// What bounds it on an H100: at the main path's shapes (Q=64 queries, N=4000
// centroids, D=128) the function moves 2 MB of centroids, about 0.6 us at
// 3.35 TB/s, and does 65 MFLOP, about 1 us at 67 TFLOP/s on the float32
// cores.  The launch itself (a few us) dominates.
//
// Design: one block per query.  The block scores every centroid (one warp
// per centroid, lanes striding over D, so a row is read in coalesced 128-byte
// pieces; the 2 MB of centroids stay in the 50 MB L2 across blocks) and keeps
// all N distances in shared memory (16 KB at N = 4000) as order-preserving
// integers.  It then runs nprobe rounds of a block-wide minimum over the
// packed (distance, centroid id) key, so a tie goes to the lower centroid
// id, as the reference's top_k does.  The TPU kernel's sequential carry over
// centroid tiles is not needed: one block sees the whole of N.
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kTaken = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
coarse_topk_kernel(const float* __restrict__ queries,
                   const float* __restrict__ cents, int N, int D, int NP,
                   int* __restrict__ out_i, float* __restrict__ out_d) {
  extern __shared__ unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);             // [D]
  uint32_t* dist = reinterpret_cast<uint32_t*>(qs + D);   // [N] ord_f32 bits
  __shared__ unsigned long long red[kThreads / 32];
  __shared__ float qn_s;

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int d = threadIdx.x; d < D; d += blockDim.x)
    qs[d] = queries[static_cast<size_t>(qi) * D + d];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[d], qs[d], s);
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  const float qn = qn_s;

  for (int c = warp; c < N; c += nwarps) {
    const float* row = cents + static_cast<size_t>(c) * D;
    float dot = 0.f, cn = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = row[d];
      dot = fmaf(qs[d], v, dot);
      cn = fmaf(v, v, cn);
    }
    dot = warp_sum(dot);
    cn = warp_sum(cn);
    if (lane == 0) dist[c] = ord_f32(l2_from_parts(qn, cn, dot));
  }
  __syncthreads();

  for (int r = 0; r < NP; ++r) {
    unsigned long long best = EMPTY_KEY;
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const uint32_t k = dist[c];
      if (k != kTaken) {
        const unsigned long long key =
            (static_cast<unsigned long long>(k) << 32) | static_cast<uint32_t>(c);
        best = key < best ? key : best;
      }
    }
    best = warp_min(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red[lane] : EMPTY_KEY;
      best = warp_min(best);
      if (lane == 0) {
        float d;
        int id;
        store_key(best, &d, &id);
        out_i[static_cast<size_t>(qi) * NP + r] = id;
        out_d[static_cast<size_t>(qi) * NP + r] = d;
        if (id >= 0) dist[id] = kTaken;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// queries [Q, D] f32, cents [N, D] f32 -> out_i [Q, NP] i32, out_d [Q, NP]
// f32, both ascending by (distance, centroid id).  Requires 0 < NP <= N.
extern "C" int coarse_topk_f32(const float* queries, const float* cents, int Q,
                               int N, int D, int NP, int* out_i, float* out_d,
                               void* stream) {
  const size_t smem = static_cast<size_t>(D + N) * sizeof(float);
  cudaError_t err = allow_smem(coarse_topk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  coarse_topk_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, cents, N, D, NP, out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}
