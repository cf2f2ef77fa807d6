// IVF block scan, scores only: out[c][q][t] = ||q||^2 + ||v||^2 - 2 q.v for
// every query q and every row t of candidate block block_ids[c].
//
// Replaces the TPU kernel `_scan_kernel` / `ivf_block_scan` in
// src/repro/kernels/ivf_scan.py (body at :91, pallas_call at :130), which
// serves the `union_pallas` comparison path: the caller masks the [C, Q, T]
// scores and selects k over C*T.  Hole ids (-1) are scored against block 0,
// as the TPU kernel's clamped index map does.  Payloads are float32 or
// bfloat16; for bf16 the query is rounded to bf16 and the products are
// taken and summed in float32 (a product of two bf16 values is exact in
// float32), ||v||^2 comes from the bf16 value widened, ||q||^2 from the
// float32 query, as in the TPU kernel.
//
// What bounds it on an H100, at SIFT1M's union shapes (C = 1569, Q = 64,
// T = 1024, D = 128): float32, operations: 2*C*Q*T*D = 26.3 GFLOP of FMAs,
// 0.39 ms at 67 TFLOP/s, against 1.23 GB of blocks read and scores
// written, 0.37 ms at 3.35 TB/s.  The float32 contract bars TF32, so the
// product runs on the CUDA cores.  bfloat16, bytes: 0.82 GB, 0.245 ms; its
// product runs on the tensor cores (mma.sync bf16 -> f32), as the TPU
// kernel's runs on the MXU, far below their rate.
//
// Design.  A pre-pass computes ||q||^2 once per query (a warp a query).
// The scan is a persistent grid of (worker, tile of 64 queries), one
// 256-thread block an SM: a worker takes an even share of the items
// (candidate, tile of 256 rows), in order, and keeps its query tile
// resident in shared memory for all of them, staged once (rounded to bf16
// once for bf16 payloads).  Row tiles stream in stages of 128 bytes a row
// (32 float32 or 64 bf16 dims) through a ring of `ns` stages filled by
// cp.async, so the next stages, and the next item's first, load while one
// is scored; one barrier a stage.  Rows past T and dims past D are
// zero-filled.  A pool whose rows are not 16-byte aligned (an odd D, a
// view off 16 bytes) is staged by 4-byte cp.async, or for bf16 rows off 4
// bytes by 2-byte loads.  Where the query tile's D does not fit beside the
// ring, it is held `slab` dims at a time and restaged per item.
// * float32: a warp scores 32 queries x 64 rows, a thread an 8 x 8
//   micro-tile with IEEE fmaf, over a stage's 8 units of 4 dims: per unit 8
//   LDS.128 of its rows and 8 of its queries for 256 FMAs.  A stage holds
//   rows unpadded, a row's 16-byte units swizzled by (row / 4) % 8, so the
//   eight rows a warp reads at once (rows 4 apart) and the cp.async stores
//   fall in distinct bank groups; each row's units are shared by 4 lanes
//   (broadcast).  The query tile is [dim][64 + 4].
// * bfloat16: a warp scores 64 queries x 32 rows by mma.sync m16n8k16,
//   fragments by ldmatrix from the query tile [64][slab + 8] and the stage
//   [256][64 + 8] (16 bytes of padding put a tile's 8 rows in 8 bank
//   groups).  Each 16-dim step starts from zero and is added to the running
//   sum with a round-to-nearest float32 add: the mma's own accumulation
//   truncates, and the kernel is bound by bytes, not by these adds.
// ||v||^2 is summed from each stage by all threads (a thread a row), in
// the order of the dims for bf16.  The epilogue rounds as the reference's
// float32 expression does, (qn + vn) - 2*dot with no FMA contraction, and
// writes each score once, by 16-byte streaming stores where T % 4 == 0.
#include <cuda_bf16.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kQT = 64;        // queries a tile
constexpr int kRows = 256;     // rows a tile
constexpr int kChunkF = 32;    // float32 dims a stage (128 bytes a row)
constexpr int kQStrideF = kQT + 4;  // the float32 query tile: [dim][68]
constexpr int kChunkB = 64;    // bf16 dims a stage (128 bytes a row)
constexpr int kRowB = kChunkB + 8;  // a staged bf16 row: mma_row(kChunkB)

template <typename T>
__host__ __device__ constexpr int chunk_dims() {
  return std::is_same<T, float>::value ? kChunkF : kChunkB;
}
template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return std::is_same<T, float>::value ? kRows * kChunkF : kRows * kRowB;
}

// ||q||^2 of the float32 queries, once per call: a warp a query
__global__ void __launch_bounds__(kThreads)
query_norms(const float* __restrict__ queries, int Q, int D,
            float* __restrict__ qn) {
  const int qi = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= Q) return;  // whole warps
  const float* row = queries + static_cast<size_t>(qi) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
  s = warp_sum(s);
  if (lane == 0) qn[qi] = s;
}

// dims [d0, d0 + chunk) of rows [t0, t0 + 256) of one block into a stage;
// VEC: bytes a copy (16, 4, or 2 by plain loads)
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* rows,
                                           int t0, int T_m, int D, int d0) {
  const int tid = threadIdx.x;
  if constexpr (VEC == 16) {
#pragma unroll
    for (int k = 0; k < kRows * kChunkF / 4 / kThreads; ++k) {
      const int f = k * kThreads + tid, R = f >> 3, u = f & 7;
      const int t = t0 + R, d = d0 + 4 * u;
      const bool ok = t < T_m && d < D;
      cp_async16_zfill(dst + R * kChunkF + ((u ^ ((R >> 2) & 7)) << 2),
                       ok ? rows + static_cast<size_t>(t) * D + d : rows, ok);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < kRows * kChunkF / kThreads; ++k) {
      const int f = k * kThreads + tid, R = f >> 5, e = f & 31;
      const int t = t0 + R, d = d0 + e;
      const bool ok = t < T_m && d < D;
      cp_async4_zfill(
          dst + R * kChunkF + (((e >> 2) ^ ((R >> 2) & 7)) << 2) + (e & 3),
          ok ? rows + static_cast<size_t>(t) * D + d : rows, ok);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* rows, int t0,
                                           int T_m, int D, int d0) {
  const int tid = threadIdx.x;
  if constexpr (VEC == 16) {
#pragma unroll
    for (int k = 0; k < kRows * kChunkB / 8 / kThreads; ++k) {
      const int f = k * kThreads + tid, R = f >> 3, u = f & 7;
      const int t = t0 + R, d = d0 + 8 * u;
      const bool ok = t < T_m && d < D;
      cp_async16_zfill(dst + R * kRowB + 8 * u,
                       ok ? rows + static_cast<size_t>(t) * D + d : rows, ok);
    }
  } else if constexpr (VEC == 4) {
#pragma unroll 8
    for (int k = 0; k < kRows * kChunkB / 2 / kThreads; ++k) {
      const int f = k * kThreads + tid, R = f >> 5, e = f & 31;
      const int t = t0 + R, d = d0 + 2 * e;
      const bool ok = t < T_m && d < D;
      cp_async4_zfill(dst + R * kRowB + 2 * e,
                      ok ? rows + static_cast<size_t>(t) * D + d : rows, ok);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < kRows * kChunkB / kThreads; ++k) {
      const int f = k * kThreads + tid, R = f >> 6, e = f & 63;
      const int t = t0 + R, d = d0 + e;
      dst[R * kRowB + e] = (t < T_m && d < D)
                               ? rows[static_cast<size_t>(t) * D + d]
                               : __float2bfloat16(0.f);
    }
  }
}

// dims [d0, d0 + width) of the query tile, zero past Q and D
__device__ __forceinline__ void stage_queries(float* qs, const float* queries,
                                              int q0, int Q, int D, int d0,
                                              int width, int /*slab*/) {
  for (int i = threadIdx.x; i < kQT * width; i += kThreads) {
    const int qq = i & (kQT - 1), dl = i / kQT, d = d0 + dl;
    qs[dl * kQStrideF + qq] =
        (q0 + qq < Q && d < D) ? queries[static_cast<size_t>(q0 + qq) * D + d]
                               : 0.f;
  }
}

__device__ __forceinline__ void stage_queries(__nv_bfloat16* qs,
                                              const float* queries, int q0,
                                              int Q, int D, int d0, int width,
                                              int slab) {
  const int stride = mma_row(slab);
  for (int i = threadIdx.x; i < kQT * width; i += kThreads) {
    const int qq = i / width, dl = i - qq * width, d = d0 + dl;
    qs[qq * stride + dl] = __float2bfloat16(
        (q0 + qq < Q && d < D) ? queries[static_cast<size_t>(q0 + qq) * D + d]
                               : 0.f);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// four scores of one query at rows t0 + r .. t0 + r + 3, those inside T
__device__ __forceinline__ void store4(float* dst, int r, int t0, int T_m,
                                      float4 o) {
  if ((T_m & 3) == 0 && t0 + r + 3 < T_m) {
    __stcs(reinterpret_cast<float4*>(dst + r), o);
  } else {
    const float v[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + r + i < T_m) __stcs(dst + r + i, v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
block_scan(const float* __restrict__ queries, const T* __restrict__ pool,
           int Q, int T_m, int D, const int* __restrict__ block_ids,
           int n_items, int n_tiles, int ns, int slab,
           const float* __restrict__ qn, float* __restrict__ out) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kChunk = chunk_dims<T>();
  constexpr int kStage = stage_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);                          // [ns][kStage]
  float* vn_s = reinterpret_cast<float*>(stages + static_cast<size_t>(ns) * kStage);
  T* qs = reinterpret_cast<T*>(vn_s + kRows);                      // the query tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQT;
  const int W = gridDim.x, w = blockIdx.x;
  const int i0 = static_cast<int>(static_cast<long long>(n_items) * w / W);
  const int i1 = static_cast<int>(static_cast<long long>(n_items) * (w + 1) / W);
  const int nch = (D + kChunk - 1) / kChunk;  // stages an item
  const int cps = slab / kChunk;              // stages a slab of the query tile
  const long long total = static_cast<long long>(i1 - i0) * nch;
  if (total == 0) return;

  // producer: the stage it copies next
  int p_item = i0, p_ch = 0, p_slot = 0, p_t0 = 0;
  const T* p_rows = pool;
  auto locate = [&]() {
    const int c = p_item / n_tiles;
    p_t0 = (p_item - c * n_tiles) * kRows;
    p_rows = pool + static_cast<size_t>(max(block_ids[c], 0)) * T_m * D;
  };
  locate();
  auto issue = [&](long long s) {
    if (s < total) {
      stage_rows<VEC>(stages + static_cast<size_t>(p_slot) * kStage, p_rows,
                      p_t0, T_m, D, p_ch * kChunk);
      if (++p_slot == ns) p_slot = 0;
      if (++p_ch == nch) {
        p_ch = 0;
        if (++p_item < i1) locate();  // its id loads while this stage is scored
      }
    }
    cp_async_commit();  // one group a stage, empty past the end
  };
  for (int s = 0; s < ns - 1; ++s) issue(s);

  // this thread's queries: float32 q0 + (warp & 1) * 32 + (lane >> 3) * 8 + a;
  // bf16 q0 + (a >> 1) * 16 + (lane >> 2) + (a & 1) * 8
  float qn_r[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int qi = kF32 ? q0 + (warp & 1) * 32 + (lane >> 3) * 8 + a
                        : q0 + (a >> 1) * 16 + (lane >> 2) + (a & 1) * 8;
    qn_r[a] = qi < Q ? qn[qi] : 0.f;
  }

  // float32: acc[a][j], query a, row j; bf16: acc[mt][nt][4] fragments
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float vn = 0.f;  // ||v||^2 of tile row tid
  int c_item = i0, c_ch = 0, c_slot = 0, q_slab = -1;

  for (long long s = 0; s < total; ++s) {
    cp_async_wait(ns - 2);
    __syncthreads();  // stage s is in; every thread is done with stage s - 1
    issue(s + ns - 1);
    const int sl = c_ch / cps;
    if (sl != q_slab) {  // once, unless the query tile is held in slabs
      const int d0 = sl * slab;
      stage_queries(qs, queries, q0, Q, D, d0, min(slab, nch * kChunk - d0), slab);
      __syncthreads();
      q_slab = sl;
    }
    const T* sb = stages + static_cast<size_t>(c_slot) * kStage;
    const int db = (c_ch - sl * cps) * kChunk;  // the stage's dims in the slab

    if constexpr (kF32) {
      const int wq = warp & 1, wr = warp >> 1, qg = lane >> 3, rg = lane & 7;
      const float* rowp = sb + (wr * 64 + rg * 4) * kChunkF;
      const float* qp = qs + db * kQStrideF + wq * 32 + qg * 8;
#pragma unroll
      for (int u = 0; u < kChunkF / 4; ++u) {
        float4 v[8];  // rows wr*64 + (j/4)*32 + rg*4 + j%4, dims 4u..4u+3
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = *reinterpret_cast<const float4*>(
              rowp + ((j >> 2) * 32 + (j & 3)) * kChunkF + ((u ^ rg) << 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* qe = qp + (4 * u + e) * kQStrideF;
          const float4 qa = *reinterpret_cast<const float4*>(qe);
          const float4 qb = *reinterpret_cast<const float4*>(qe + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float x = lane_of(v[j], e);
#pragma unroll
            for (int a = 0; a < 8; ++a) acc[a * 8 + j] = fmaf(qv[a], x, acc[a * 8 + j]);
          }
        }
      }
      // ||v||^2 of row tid: its 8 units from unit tid % 8 on (no conflicts)
      const float* my = sb + tid * kChunkF;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(my + (((k + tid) & 7) << 2));
        vn = fmaf(x.x, x.x, vn);
        vn = fmaf(x.y, x.y, vn);
        vn = fmaf(x.z, x.z, vn);
        vn = fmaf(x.w, x.w, vn);
      }
    } else {
      const int stride = mma_row(slab);
      const __nv_bfloat16* qa_p = qs + (lane & 15) * stride + db + (lane >> 4) * 8;
      const __nv_bfloat16* rb_p =
          sb + (warp * 32 + (lane & 7) + ((lane >> 4) << 3)) * kRowB + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < kChunkB / 16; ++ks) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldsm_x4(a[mt], qa_p + mt * 16 * stride + ks * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) ldsm_x4(b[np], rb_p + np * 16 * kRowB + ks * 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(part, a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
            float* c = acc + (mt * 4 + nt) * 4;
#pragma unroll
            for (int x = 0; x < 4; ++x) c[x] = __fadd_rn(c[x], part[x]);
          }
      }
      // ||v||^2 of row tid, widened, in the order of the dims
      const __nv_bfloat16* my = sb + tid * kRowB;
#pragma unroll
      for (int u = 0; u < kChunkB / 8; ++u) {
        float f[8];
        widen16<__nv_bfloat16>(*reinterpret_cast<const uint4*>(my + 8 * u), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) vn = fmaf(f[i], f[i], vn);
      }
    }
    if (++c_slot == ns) c_slot = 0;
    if (++c_ch < nch) continue;

    // the item's last stage: write its 64 x 256 scores
    vn_s[tid] = vn;
    vn = 0.f;
    __syncthreads();
    const int c = c_item / n_tiles, t0 = (c_item - c * n_tiles) * kRows;
    float* base = out + static_cast<size_t>(c) * Q * T_m + t0;
    if constexpr (kF32) {
      const int wq = warp & 1, wr = warp >> 1, qg = lane >> 3, rg = lane & 7;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int qi = q0 + wq * 32 + qg * 8 + a;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr * 64 + h * 32 + rg * 4;
          const float4 vv = *reinterpret_cast<const float4*>(vn_s + r);
          const float* x = acc + a * 8 + h * 4;
          const float4 o = make_float4(
              l2_from_parts(qn_r[a], vv.x, x[0]), l2_from_parts(qn_r[a], vv.y, x[1]),
              l2_from_parts(qn_r[a], vv.z, x[2]), l2_from_parts(qn_r[a], vv.w, x[3]));
          if (qi < Q) store4(base + static_cast<size_t>(qi) * T_m, r, t0, T_m, o);
        }
      }
    } else {
      // a lane pair (l, l^1) trades halves so that each lane holds 4
      // consecutive rows of one query: the even lane query g, the odd g + 8
      const int odd = lane & 1, cb = 2 * ((lane & 3) - odd);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* x = acc + (mt * 4 + nt) * 4;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? x[0] : x[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? x[1] : x[3], 1);
          const float v0 = odd ? s0 : x[0], v1 = odd ? s1 : x[1];
          const float v2 = odd ? x[2] : s0, v3 = odd ? x[3] : s1;
          const int qi = q0 + mt * 16 + (lane >> 2) + 8 * odd;
          const float qv = odd ? qn_r[mt * 2 + 1] : qn_r[mt * 2];
          const int r = warp * 32 + nt * 8 + cb;
          const float4 vv = *reinterpret_cast<const float4*>(vn_s + r);
          const float4 o = make_float4(
              l2_from_parts(qv, vv.x, v0), l2_from_parts(qv, vv.y, v1),
              l2_from_parts(qv, vv.z, v2), l2_from_parts(qv, vv.w, v3));
          if (qi < Q) store4(base + static_cast<size_t>(qi) * T_m, r, t0, T_m, o);
        }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    c_ch = 0;
    ++c_item;
  }
  cp_async_wait(0);
}

template <typename T>
size_t smem_bytes(int ns, int slab) {
  const size_t qtile = std::is_same<T, float>::value
                           ? static_cast<size_t>(slab) * kQStrideF * 4
                           : static_cast<size_t>(kQT) * mma_row(slab) * 2;
  return static_cast<size_t>(ns) * stage_elems<T>() * sizeof(T) + kRows * 4 + qtile;
}

template <typename T, int VEC>
cudaError_t scan(const float* queries, const T* pool, int Q, int T_m, int D,
                 const int* block_ids, int n_items, int n_tiles, int ns,
                 int slab, int workers, const float* qn, float* out,
                 cudaStream_t st) {
  const size_t smem = smem_bytes<T>(ns, slab);
  const cudaError_t err = allow_smem(block_scan<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(workers, (Q + kQT - 1) / kQT);
  block_scan<T, VEC><<<grid, kThreads, smem, st>>>(
      queries, pool, Q, T_m, D, block_ids, n_items, n_tiles, ns, slab, qn, out);
  return cudaGetLastError();
}

template <typename T>
int launch(const float* queries, const T* pool, int Q, int T_m, int D,
           const int* block_ids, int C, int vec, int ns, int slab, int workers,
           float* qn, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  query_norms<<<(Q + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      queries, Q, D, qn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (T_m + kRows - 1) / kRows;
  const int n_items = C * n_tiles;
  if (vec == 16) {
    err = scan<T, 16>(queries, pool, Q, T_m, D, block_ids, n_items, n_tiles, ns,
                      slab, workers, qn, out, st);
  } else if constexpr (std::is_same<T, float>::value) {  // float rows: 4 bytes
    err = scan<T, 4>(queries, pool, Q, T_m, D, block_ids, n_items, n_tiles, ns,
                     slab, workers, qn, out, st);
  } else if (vec == 4) {
    err = scan<T, 4>(queries, pool, Q, T_m, D, block_ids, n_items, n_tiles, ns,
                     slab, workers, qn, out, st);
  } else {
    err = scan<T, 2>(queries, pool, Q, T_m, D, block_ids, n_items, n_tiles, ns,
                     slab, workers, qn, out, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// queries [Q, D] f32; pool [P, T, D] f32 | bf16; block_ids [C] i32 (-1 reads
// block 0) -> out [C, Q, T] f32, with qn [Q] f32 scratch (||q||^2).  vec:
// bytes a row copy (16: rows 16-byte aligned; 4; 2, bf16 only); ns stages
// (2-4); the query tile held `slab` dims at a time (a multiple of 32 for
// f32, 64 for bf16); `workers` blocks a tile of 64 queries
// (ivf_scan.plan_block_scan).  C, Q > 0.
extern "C" int ivf_block_scan_f32(const float* queries, const float* pool,
                                  int Q, int T_m, int D, const int* block_ids,
                                  int C, int vec, int ns, int slab, int workers,
                                  float* qn, float* out, void* stream) {
  return launch<float>(queries, pool, Q, T_m, D, block_ids, C, vec, ns, slab,
                       workers, qn, out, stream);
}

extern "C" int ivf_block_scan_bf16(const float* queries, const void* pool,
                                   int Q, int T_m, int D, const int* block_ids,
                                   int C, int vec, int ns, int slab, int workers,
                                   float* qn, float* out, void* stream) {
  return launch<__nv_bfloat16>(queries,
                               static_cast<const __nv_bfloat16*>(pool), Q, T_m,
                               D, block_ids, C, vec, ns, slab, workers, qn, out,
                               stream);
}
