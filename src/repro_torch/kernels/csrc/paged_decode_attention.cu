// Paged decode attention over a block-pool KV cache (one new token per
// sequence against every cached position).
//
// Replaces the TPU kernel `_paged_attn_kernel` / `paged_decode_attention` in
// src/repro/kernels/paged_attention.py (body at :32, pallas_call at :134).
// For sequence b and query head h (GQA: head h reads KV head h / G, with
// G = H / KVH) it computes softmax(scale * q.K^T) V over the positions
// p < lengths[b], position p living in slot p % T of pool block
// tables[b][p / T].  Logits, the online softmax (running max, sum and
// numerator) and the products are float32; the output is written in q's
// type.  Length 0 writes zeros, as the TPU kernel's (0 / max(0, 1e-30))
// does.
//
// What bounds it on an H100: bytes.  It must read the K and V rows of every
// cached position once: 2 * sum_b(lengths[b]) * KVH * dh * sizeof(T).  At
// LM_SHAPES["decode_32k"] cut to 32 sequences (32,768 positions each, 8 KV
// heads of 128, bf16) that is 4.3 GB, 1.28 ms at 3.35 TB/s, against 4
// FLOP per position, head and dimension (both products), far below any
// compute rate.
//
// Design: one block per (sequence, KV head), holding the G query heads of
// the group in registers.  The TPU kernel walks every table entry of the
// sequence in grid order, reading clamped blocks past the end and masking
// them; here the 8 warps of the block take the ceil(length / T) blocks that
// hold positions in turn, and never read a block past the end.  A warp
// scores its block's T positions for all G heads (each lane holds dh / 32
// dimensions; one warp reduction per position and head), updates its own
// online (max, sum, acc) once per block, and accumulates P.V row by row.
// At the end the warps merge their states in shared memory.  Split-K over
// the positions and tensor-core products are later work.
#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

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

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// EPL: dimensions per lane (dh <= 32 * EPL); MG: query heads per KV head
// kept in registers (G <= MG).  T_m <= 32: lane t holds position t's logit.
template <typename T, int EPL, int MG>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn(const T* __restrict__ q, const T* __restrict__ k_pool,
           const T* __restrict__ v_pool, const int* __restrict__ tables,
           const int* __restrict__ lengths, int P, int T_m, int KVH, int dh,
           int G, int NB, float scale, T* __restrict__ out) {
  extern __shared__ float merge[];  // [kWarps][G][dh + 2]: acc, max, sum
  const int b = blockIdx.x, kh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = KVH * G;
  const int len = min(lengths[b], NB * T_m);  // the table covers NB*T slots
  const int nblk = (max(len, 0) + T_m - 1) / T_m;

  float qr[MG][EPL], acc[MG][EPL], m[MG], l[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      acc[g][e] = 0.f;
      qr[g][e] = (g < G && d < dh)
                     ? widen<T>(q[(static_cast<size_t>(b) * H + kh * G + g) * dh + d])
                     : 0.f;
    }
  }

  const size_t row_stride = static_cast<size_t>(KVH) * dh;  // one slot
  for (int j = warp; j < nblk; j += kWarps) {
    // -1 entries read block 0 as the reference's clamp does; ids past the
    // pool are clamped too (the serving layer refuses to make them)
    const int blk = min(max(tables[static_cast<size_t>(b) * NB + j], 0), P - 1);
    const size_t base = (static_cast<size_t>(blk) * T_m) * row_stride + kh * dh;
    const int n_valid = min(T_m, len - j * T_m);
    float s[MG];  // lane t: logit of position j*T + t
#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] = kNegInf;
    for (int t = 0; t < n_valid; ++t) {
      const T* krow = k_pool + base + t * row_stride;
      float part[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) part[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        const float kv = d < dh ? widen<T>(krow[d]) : 0.f;
#pragma unroll
        for (int g = 0; g < MG; ++g) part[g] = fmaf(qr[g][e], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float dot = warp_sum(part[g]);
        if (lane == t) s[g] = dot * scale;
      }
    }
    float p[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      p[g] = lane < n_valid ? expf(s[g] - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
    for (int t = 0; t < n_valid; ++t) {
      const T* vrow = v_pool + base + t * row_stride;
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < dh ? widen<T>(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float pt = __shfl_sync(0xffffffffu, p[g], t);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pt, vv[e], acc[g][e]);
      }
    }
  }

  // merge the warps' (max, sum, acc) states
  const int w_stride = G * (dh + 2);
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= G) break;
    float* dst = merge + warp * w_stride + g * (dh + 2);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < dh) dst[d] = acc[g][e];
    }
    if (lane == 0) {
      dst[dh] = m[g];
      dst[dh + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, merge[w * w_stride + g * (dh + 2) + dh]);
    float sum = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* src = merge + w * w_stride + g * (dh + 2);
      const float f = expf(src[dh] - mx);
      sum = fmaf(src[dh + 1], f, sum);
      num = fmaf(src[d], f, num);
    }
    out[(static_cast<size_t>(b) * H + kh * G + g) * dh + d] =
        narrow<T>(num / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int EPL, int MG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lengths, int B, int P, int T_m,
           int KVH, int dh, int G, int NB, float scale, void* out,
           cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kWarps) * G * (dh + 2) * sizeof(float);
  const cudaError_t err = allow_smem(paged_attn<T, EPL, MG>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn<T, EPL, MG><<<dim3(B, KVH), kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, P, T_m, KVH, dh, G, NB,
      scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int by_group(const void* q, const void* k, const void* v, const int* tables,
             const int* lengths, int B, int P, int T_m, int KVH, int dh, int G,
             int NB, float scale, void* out, cudaStream_t st) {
  if (G <= 1)
    return launch<T, EPL, 1>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  if (G <= 2)
    return launch<T, EPL, 2>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  if (G <= 4)
    return launch<T, EPL, 4>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  return launch<T, EPL, 8>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* tables,
             const int* lengths, int B, int P, int T_m, int KVH, int dh, int G,
             int NB, float scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 32)
    return by_group<T, 1>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  if (dh <= 64)
    return by_group<T, 2>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  if (dh <= 128)
    return by_group<T, 4>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
  return by_group<T, 8>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G, NB, scale, out, st);
}

}  // namespace

// q [B, KVH*G, dh]; k_pool, v_pool [P, T, KVH, dh]; tables [B, NB] i32;
// lengths [B] i32 -> out [B, KVH*G, dh], all float32 or all bfloat16.
// B > 0, B <= 2^31 - 1, KVH <= 65535, dh <= 256, G <= 8, T <= 32.
extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, const int* tables,
                                          const int* lengths, int B, int P,
                                          int T_m, int KVH, int dh, int G,
                                          int NB, float scale, void* out,
                                          void* stream) {
  return dispatch<float>(q, k_pool, v_pool, tables, lengths, B, P, T_m, KVH,
                         dh, G, NB, scale, out, stream);
}

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, const int* tables,
                                           const int* lengths, int B, int P,
                                           int T_m, int KVH, int dh, int G,
                                           int NB, float scale, void* out,
                                           void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, B, P, T_m,
                                 KVH, dh, G, NB, scale, out, stream);
}
