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
// Design (split-K, as flash-decoding), float32 here; bfloat16 runs the
// tensor-core variant `paged_attn_mma` further down, with the same split,
// partials and pass 2:
// * Pass 1, grid (sequence x KV head, split).  A split is a run of `bps`
//   whole pool blocks, planned in kernels/paged_attention.py so that the
//   grid fills the SMs several times over at short and long contexts; a
//   split that starts past the sequence's length returns at once.  A block
//   of 4 warps holds the group's G query heads in registers and walks its
//   split in tiles of up to 32 positions (32 / T whole pool blocks, or, for
//   T > 32, 32 positions of a block that spans several tiles), its table
//   entries read once into shared memory.  Each tile's
//   K and V rows (one KV head's dh contiguous values in each slot) are
//   staged in shared memory by 16-byte cp.async copies into a ring of `ns`
//   tiles, so the next tiles load while this one is scored.  The G x 32
//   logits of a tile are computed from shared memory by C threads per
//   position (one reduction of log2 C shuffles per position and head), one
//   warp per head updates the running (max, sum) and turns the logits into
//   weights, and P.V runs over the staged V with each thread owning 16
//   bytes of dh for a subset of the positions.  The split writes its
//   unnormalised (acc[G, dh], max, sum) in float32 to scratch.
// * Pass 2, grid (sequence, KV head), rescales each used split's partial by
//   exp(m_i - m), sums, and divides by the summed l floored at 1e-30.
// -1 table entries and ids past the pool are clamped into it (the
// reference's clamped gather); only blocks holding positions are read.
// A GQA group of G > 8 query heads runs as launches of up to 8 heads
// (pass 1 and pass 2 each), one after the other over the same scratch:
// every kernel takes the group's first head g0 and its heads Gc.
#include "mma_bf16.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // positions per tile: one per lane in the softmax
constexpr int kMaxGroup = 8;  // query heads a launch holds in registers

// positions of a float32 tile: whole pool blocks, or 32 of a larger block
__host__ __device__ __forceinline__ int tile_positions(int T_m) {
  return T_m <= kTile ? (kTile / T_m) * T_m : kTile;
}
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

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

// Bytes of the staging ring, which the final reduction over position
// groups reuses; the wrapper's planner computes the same.
__host__ __device__ __forceinline__ int ring_bytes(int ns, int tp, int nv, int G,
                                                   int dh) {
  const int ring = ns * 2 * tp * nv * 16;
  const int red = (kThreads / nv) * G * dh * 4;
  return ring > red ? ring : red;
}

// The launch bound's minimum of blocks an SM for each <MG, VPT>: the
// count ptxas reaches with no minimum, but 6 (80 registers) for <2, 2>,
// where its own aim of 7 (72 registers) spills long-lived scalars that
// the tile loop reloads.
template <int MG, int VPT>
constexpr int kSplitMinBlocks = VPT == 1 ? (MG == 1 ? 9 : MG == 2 ? 7 : MG == 4 ? 6 : 4)
                                         : (MG == 1 ? 8 : MG == 2 ? 6 : MG == 4 ? 5 : 3);

// MG: query heads per KV head kept in registers (Gc <= MG): heads g0 ..
// g0 + Gc - 1 of each group of G.  VPT: 16-byte vectors of a K row per
// thread in the logits (NV <= 32 * VPT).
template <typename T, int MG, int VPT>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks<MG, VPT>)
paged_attn_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ lengths, int P, int T_m, int KVH,
                 int dh, int G, int g0, int Gc, int NB, int bps, int ns,
                 float scale, float* __restrict__ partial) {
  constexpr int VE = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.x = b * KVH + kh: the KV heads of a position range run side by
  // side and read neighbouring bytes of each slot
  const int b = blockIdx.x / KVH, kh = blockIdx.x % KVH, s = blockIdx.y, S = gridDim.y;
  const int len = min(max(lengths[b], 0), NB * T_m);  // the table covers NB*T
  const int pos0 = s * bps * T_m;
  if (pos0 >= len) return;  // nothing resident here: pass 2 skips the split
  const int n_pos = min(len - pos0, bps * T_m);
  const int TP = tile_positions(T_m);
  const int ntiles = (n_pos + TP - 1) / TP;
  const int NV = dh * static_cast<int>(sizeof(T)) / 16;  // vectors per row
  const int tile_vecs = TP * NV;
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [ns][K|V][TP][NV]
  float* logit = reinterpret_cast<float*>(smem + ring_bytes(ns, TP, NV, Gc, dh));
  float* m_s = logit + MG * kTile;  // [MG] running max
  float* l_s = m_s + MG;            // [MG] running sum
  float* alpha_s = l_s + MG;        // [MG] this tile's rescale
  int* blk_s = reinterpret_cast<int*>(alpha_s + MG);  // [bps] the split's blocks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  // logits: C threads per position (a power of two), PPP positions a pass
  const int C = NV > 16 ? 32 : NV > 8 ? 16 : NV > 4 ? 8 : NV > 2 ? 4 : NV > 1 ? 2 : 1;
  const int PPP = kThreads / C;
  const int c = tid % C, pr = tid / C;
  // P.V: thread owns vector `vec` of dh for positions tp, tp + n_tp, ...
  const int n_tp = kThreads / NV;
  const int vec = tid % NV, tp = tid / NV;

  float qr[MG][VPT * VE];
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int u = c + C * k;
      if (g < Gc && u < NV) {
        const uint4 raw = reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(b) * H + kh * G + g0 + g) * dh)[u];
        widen16<T>(raw, &qr[g][k * VE]);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) qr[g][k * VE + e] = 0.f;
      }
    }
  if (tid < MG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // the split's table entries, clamped into the pool, read once
  const int n_blk = (n_pos + T_m - 1) / T_m;
  for (int j = tid; j < n_blk; j += kThreads)
    blk_s[j] = min(max(tables[static_cast<size_t>(b) * NB + s * bps + j], 0), P - 1);
  __syncthreads();

  const uint4* kg = reinterpret_cast<const uint4*>(k_pool);
  const uint4* vg = reinterpret_cast<const uint4*>(v_pool);
  auto load_tile = [&](int i, int st) {
    const int p_first = i * TP;  // within the split
    const int rows = min(TP, n_pos - p_first);
    uint4* kd = ring + static_cast<size_t>(st) * 2 * tile_vecs;
    uint4* vd = kd + tile_vecs;
    for (int x = tid; x < rows * NV; x += kThreads) {
      const int r = x / NV, u = x - r * NV;
      const int p = p_first + r;
      const int j = p / T_m, t = p - j * T_m;
      const size_t off = ((static_cast<size_t>(blk_s[j]) * T_m + t) * KVH + kh) * NV + u;
      cp_async16(kd + x, kg + off);
      cp_async16(vd + x, vg + off);
    }
  };

  float acc[MG][VE];
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < ns - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(ns - 2);  // tile i has landed (this thread's copies)
    __syncthreads();        // ... everyone's; tile i - 1's stage is free
    if (i + ns - 1 < ntiles) load_tile(i + ns - 1, (i + ns - 1) % ns);
    cp_async_commit();
    const uint4* kt = ring + static_cast<size_t>(i % ns) * 2 * tile_vecs;
    const uint4* vt = kt + tile_vecs;
    const int nvalid = min(TP, n_pos - i * TP);

    // logits of the tile: G per position, one reduction each
    for (int r0 = 0; r0 < nvalid; r0 += PPP) {  // uniform over the block
      const int r = r0 + pr;
      float part[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) part[g] = 0.f;
      if (r < nvalid) {
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int u = c + C * k;
          if (u < NV) {
            float kv[VE];
            widen16<T>(kt[r * NV + u], kv);
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                part[g] = fmaf(qr[g][k * VE + e], kv[e], part[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MG; ++g)
        for (int o = C >> 1; o > 0; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      if (c == 0 && r < nvalid) {
#pragma unroll
        for (int g = 0; g < MG; ++g)
          if (g < Gc) logit[g * kTile + r] = part[g] * scale;
      }
    }
    __syncthreads();
    // online softmax, one warp per head: logits become weights
    for (int g = warp; g < Gc; g += kThreads / 32) {
      const float x = lane < nvalid ? logit[g * kTile + lane] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = lane < nvalid ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(p);
      logit[g * kTile + lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // P.V over the staged V
    if (tp < n_tp) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float a = g < Gc ? alpha_s[g] : 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] *= a;
      }
      for (int t = tp; t < nvalid; t += n_tp) {
        float vv[VE];
        widen16<T>(vt[t * NV + vec], vv);
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= Gc) break;
          const float pt = logit[g * kTile + t];
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(pt, vv[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: sum the position groups' acc in it

  float* red = reinterpret_cast<float*>(smem);  // [n_tp][Gc][dh]
  if (tp < n_tp) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= Gc) break;
#pragma unroll
      for (int e = 0; e < VE; ++e) red[(tp * Gc + g) * dh + vec * VE + e] = acc[g][e];
    }
  }
  __syncthreads();
  float* out = partial + ((static_cast<size_t>(b) * KVH + kh) * S + s) * Gc * (dh + 2);
  for (int idx = tid; idx < Gc * dh; idx += kThreads) {
    const int g = idx / dh, d = idx - g * dh;
    float sum = 0.f;
    for (int w = 0; w < n_tp; ++w) sum += red[(w * Gc + g) * dh + d];
    out[g * (dh + 2) + d] = sum;
  }
  if (tid < Gc) {
    out[tid * (dh + 2) + dh] = m_s[tid];
    out[tid * (dh + 2) + dh + 1] = l_s[tid];
  }
}

// ---- bfloat16: tensor cores ----------------------------------------------
//
// The same split, scored by mma.sync m16n8k16 (bf16 in, float32 out): the
// float32 version above issues about 700 instructions a thread for a tile
// of 32 positions (FMAs, bf16 widening, shuffle reductions), which held it
// at twice SDPA's time.  A block holds up to 4 warps, one per KV head of a
// group of heads, and walks the split's positions in steps of 16.  Its
// threads copy each step's slots for all the group's heads together, in
// address order (1 KB of each slot at llama3-8b's shapes), by 16-byte
// cp.async into a ring of `ns` steps in shared memory (zero-filled past
// the length, each position's row padded by 16 bytes so ldmatrix reads
// distinct banks), one barrier a step; each warp then scores its head.
// Small blocks keep 2-3 of them on an SM, so one block's scoring overlaps
// another's copies (on the H100 this beat blocks of 8 heads and 3 stages,
// and a warp or a block per head).  Per step: S^T[16 heads x 16 positions] = q K^T by dh / 16 x 2 mma
// (q's Gc <= 8 heads are the rows, zero-padded to 16); the warp's online
// softmax on the fragments (a quad of lanes holds one head, in base 2);
// P.V by dh / 8 mma with P's fragments reused as the A operand: a bf16
// high part in the head rows and the bf16 rounding of the rest in the
// padding rows (P = hi + lo to about 2^-16), so the weights keep float32
// accuracy where one bf16 product would round them to 2^-9 (as SDPA
// does), at no extra mma.  Each warp writes its head's partial, in the
// float32 kernel's layout, and the same pass 2 merges the splits.
constexpr int kMmaWarps = 4;  // KV heads a block, at most
constexpr int kStep = 16;     // positions a step
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// MAXKC: 16-value chunks of dh held in registers (dh <= 16 * MAXKC)
template <int MAXKC>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
paged_attn_mma(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pool,
               const __nv_bfloat16* __restrict__ v_pool,
               const int* __restrict__ tables, const int* __restrict__ lengths,
               int P, int T_m, int KVH, int dh, int G, int g0, int Gc, int NB,
               int bps, int ns, float scale, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.x = b * groups + group of blockDim.x / 32 KV heads
  const int hc = blockDim.x >> 5, groups = (KVH + hc - 1) / hc;
  const int b = blockIdx.x / groups, s = blockIdx.y, S = gridDim.y;
  const int len = min(max(lengths[b], 0), NB * T_m);
  const int pos0 = s * bps * T_m;
  if (pos0 >= len) return;  // nothing resident here: pass 2 skips the split
  const int n_pos = min(len - pos0, bps * T_m);
  const int nsteps = (n_pos + kStep - 1) / kStep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = (blockIdx.x % groups) * hc + warp;  // this warp's KV head
  const bool scores = kh < KVH;  // the last group may have spare warps
  const int g = lane >> 2, t4 = lane & 3;  // fragment row (head) and column pair
  const int kh0 = (blockIdx.x % groups) * hc;           // the group's first head
  const int hcur = min(hc, KVH - kh0);                   // its heads
  const int nkc = dh / 16, rs = mma_row(hc * dh);        // a position's row
  const int stage = 2 * kStep * rs;  // K then V, bf16 values
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* blk_s = reinterpret_cast<int*>(smem + static_cast<size_t>(ns) * stage * 2);

  const int n_blk = (n_pos + T_m - 1) / T_m;
  for (int j = tid; j < n_blk; j += blockDim.x)
    blk_s[j] = min(max(tables[static_cast<size_t>(b) * NB + s * bps + j], 0), P - 1);
  // q's A fragments: row g < Gc is head kh*G + g0 + g; rows g + 8 are zero
  uint32_t qa[MAXKC][2];
  const __nv_bfloat16* qrow =
      q + (static_cast<size_t>(b) * KVH * G + kh * G + g0 + g) * dh;
#pragma unroll
  for (int kc = 0; kc < MAXKC; ++kc) {
    const bool ok = scores && kc < nkc && g < Gc;
    qa[kc][0] = ok ? *reinterpret_cast<const uint32_t*>(qrow + kc * 16 + 2 * t4) : 0u;
    qa[kc][1] = ok ? *reinterpret_cast<const uint32_t*>(qrow + kc * 16 + 2 * t4 + 8) : 0u;
  }

  // a thread copies 16-byte vector u of a position's row r (the group's
  // heads, contiguous in the slot), then steps by blockDim.x vectors
  // (r_step rows and u_step vectors, with a carry): no division a copy
  const int nv = hcur * dh / 8;  // 16-byte vectors a position
  const int r_step = blockDim.x / nv, u_step = blockDim.x % nv;
  auto load_step = [&](int k, int st) {
    __nv_bfloat16* kd = ring + static_cast<size_t>(st) * stage;
    __nv_bfloat16* vd = kd + kStep * rs;
    int r = tid / nv, u = tid % nv;
    int p = k * kStep + r;                    // within the split
    int j = p / T_m, t = p - j * T_m;         // its table entry and slot
    for (int x = tid; x < kStep * nv; x += blockDim.x) {
      const bool ok = p < n_pos;
      const size_t off =
          ok ? ((static_cast<size_t>(blk_s[j]) * T_m + t) * KVH + kh0) * dh + u * 8 : 0;
      cp_async16_zfill(kd + r * rs + u * 8, k_pool + off, ok);
      cp_async16_zfill(vd + r * rs + u * 8, v_pool + off, ok);
      int dr = r_step;
      u += u_step;
      if (u >= nv) {
        u -= nv;
        ++dr;
      }
      r += dr;
      p += dr;
      for (t += dr; t >= T_m; t -= T_m) ++j;
    }
  };

  float acc[2 * MAXKC][4];
#pragma unroll
  for (int d = 0; d < 2 * MAXKC; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // head g's running max (base 2), sum
  const float scale2 = scale * kLog2e;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row

  __syncthreads();  // blk_s
  for (int k = 0; k < ns - 1; ++k) {
    if (k < nsteps) load_step(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < nsteps; ++k) {
    cp_async_wait(ns - 2);
    __syncthreads();  // step k's rows from every thread; step k - 1's stage free
    if (k + ns - 1 < nsteps) load_step(k + ns - 1, (k + ns - 1) % ns);
    cp_async_commit();
    if (!scores) continue;
    // this warp's head within the staged rows
    const __nv_bfloat16* kt = ring + static_cast<size_t>(k % ns) * stage + warp * dh;
    const __nv_bfloat16* vt = kt + kStep * rs;
    const int nvalid = min(kStep, n_pos - k * kStep);

    float sc[2][4];  // S^T: rows heads, columns positions 0-7 and 8-15
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < MAXKC; ++kc) {
      if (kc < nkc) {
        uint32_t kb[4];  // (pos 0-7 | 8-15) x (dims +0-7 | +8-15)
        ldsm_x4(kb, kt + ((mi >> 1) * 8 + mr) * rs + kc * 16 + (mi & 1) * 8);
        const uint32_t a[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
        mma_bf16(sc[0], a, kb[0], kb[1]);
        mma_bf16(sc[1], a, kb[2], kb[3]);
      }
    }
    // online softmax of head g over the step's positions (a quad's lanes),
    // in base 2: logits scaled by scale * log2(e), weights exp2(x - m)
    float x[2][2], mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = n * 8 + 2 * t4 + e;
        x[n][e] = pos < nvalid ? sc[n][e] * scale2 : kNegInf;
        mx = fmaxf(mx, x[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = n * 8 + 2 * t4 + e;
        x[n][e] = pos < nvalid ? exp2f(x[n][e] - m_new) : 0.f;
        sum += x[n][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < 2 * MAXKC; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha;
    // P as the A fragment: its bf16 high part in row g, the bf16 rounding
    // of the rest in row g + 8 (rows the Gc <= 8 heads leave free), so one
    // mma takes both; rows g and g + 8 of acc are summed at the end.
    // {a01, a23, a45, a67}: positions 0-7 of row g, of row g + 8, 8-15 ...
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[n][0], x[n][1]);
      const float2 hf = __bfloat1622float2(hi);
      pa[2 * n] = bits(hi);
      pa[2 * n + 1] = bits(__floats2bfloat162_rn(x[n][0] - hf.x, x[n][1] - hf.y));
    }
#pragma unroll
    for (int dp = 0; dp < MAXKC; ++dp) {
      if (dp < nkc) {
        uint32_t vb[4];  // (pos 0-7 | 8-15) x (dims +0-7 | +8-15), transposed
        ldsm_x4_t(vb, vt + ((mi & 1) * 8 + mr) * rs + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait(0);
  // this head's partial: rows g < Gc of the fragments, max and sum
  if (scores && g < Gc) {
    float* out = partial + (((static_cast<size_t>(b) * KVH + kh) * S + s) * Gc + g) * (dh + 2);
#pragma unroll
    for (int d = 0; d < 2 * MAXKC; ++d) {
      if (d < 2 * nkc) {
        out[d * 8 + 2 * t4] = acc[d][0] + acc[d][2];  // high + low parts
        out[d * 8 + 2 * t4 + 1] = acc[d][1] + acc[d][3];
      }
    }
    if (t4 == 0) {
      out[dh] = m_run * kLn2;  // back to base e, as pass 2 reads it
      out[dh + 1] = l_run;
    }
  }
}

// Pass 2: one block per (sequence, KV head) merges the splits that hold
// positions; a sequence of length 0 has none and gets zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_merge(const float* __restrict__ partial, const int* __restrict__ lengths,
                 int T_m, int KVH, int dh, int G, int g0, int Gc, int NB, int bps,
                 int S, T* __restrict__ out) {
  extern __shared__ float wts[];          // [Gc][S]: each used split's weight
  __shared__ float inv_l[kMaxGroup];      // 1 / the summed l of each head
  const int b = blockIdx.x, kh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(max(lengths[b], 0), NB * T_m);
  const int n_used = (len + bps * T_m - 1) / (bps * T_m);
  const int stride = Gc * (dh + 2);  // one split's partial
  const float* base = partial + (static_cast<size_t>(b) * KVH + kh) * S * stride;
  // the weights exp(m_s - m) and the summed l, a warp per head
  for (int g = warp; g < Gc; g += blockDim.x / 32) {
    const float* pg = base + g * (dh + 2);
    float mx = kNegInf;
    for (int s = lane; s < n_used; s += 32) {
      const float m = pg[static_cast<size_t>(s) * stride + dh];
      wts[g * S + s] = m;
      mx = fmaxf(mx, m);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n_used; s += 32) {
      const float f = expf(wts[g * S + s] - mx);
      wts[g * S + s] = f;
      sum = fmaf(pg[static_cast<size_t>(s) * stride + dh + 1], f, sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) inv_l[g] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Gc * dh; idx += blockDim.x) {
    const int g = idx / dh, d = idx - g * dh;
    const float* pg = base + g * (dh + 2) + d;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_used; ++s)
      num = fmaf(pg[static_cast<size_t>(s) * stride], wts[g * S + s], num);
    out[(static_cast<size_t>(b) * KVH * G + kh * G + g0 + g) * dh + d] =
        narrow<T>(n_used ? num * inv_l[g] : 0.f);
  }
}

// pass 2's launch: shared memory for Gc x S weights
template <typename T>
int launch_merge_splits(const float* partial, const int* lengths, int B, int T_m,
                        int KVH, int dh, int G, int g0, int Gc, int NB, int bps,
                        int S, void* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(Gc) * S * sizeof(float);
  const cudaError_t err = allow_smem(paged_attn_merge<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_merge<T><<<dim3(B, KVH), kThreads, smem, st>>>(
      partial, lengths, T_m, KVH, dh, G, g0, Gc, NB, bps, S, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MG, int VPT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lengths, int B, int P, int T_m,
           int KVH, int dh, int G, int g0, int Gc, int NB, int bps, int S,
           int ns, float scale, float* partial, void* out, cudaStream_t st) {
  const int tp = tile_positions(T_m);
  const int nv = dh * static_cast<int>(sizeof(T)) / 16;
  const size_t smem = ring_bytes(ns, tp, nv, Gc, dh) +
                      (MG * kTile + 3 * MG + bps) * sizeof(float);
  cudaError_t err = allow_smem(paged_attn_split<T, MG, VPT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_split<T, MG, VPT><<<dim3(B * KVH, S), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, P, T_m, KVH, dh, G, g0,
      Gc, NB, bps, ns, scale, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge_splits<T>(partial, lengths, B, T_m, KVH, dh, G, g0, Gc, NB,
                                bps, S, out, st);
}

template <typename T, int VPT>
int by_group(const void* q, const void* k, const void* v, const int* tables,
             const int* lengths, int B, int P, int T_m, int KVH, int dh, int G,
             int g0, int Gc, int NB, int bps, int S, int ns, float scale,
             float* partial, void* out, cudaStream_t st) {
#define PAGED_LAUNCH(MG)                                                       \
  return launch<T, MG, VPT>(q, k, v, tables, lengths, B, P, T_m, KVH, dh, G,  \
                            g0, Gc, NB, bps, S, ns, scale, partial, out, st)
  if (Gc <= 1) PAGED_LAUNCH(1);
  if (Gc <= 2) PAGED_LAUNCH(2);
  if (Gc <= 4) PAGED_LAUNCH(4);
  PAGED_LAUNCH(8);
#undef PAGED_LAUNCH
}

template <int MAXKC>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const int* tables, const int* lengths, int B, int P, int T_m,
               int KVH, int dh, int G, int g0, int Gc, int NB, int bps, int S,
               int ns, float scale, float* partial, void* out, cudaStream_t st) {
  // KV heads a block: up to 4, as many as shared memory holds the rings of
  // (kernels/paged_attention.py plans the same)
  int hc = KVH < kMmaWarps ? KVH : kMmaWarps;
  auto ring = [&](int h) {
    return static_cast<size_t>(ns) * 2 * kStep * mma_row(h * dh) * 2;
  };
  while (hc > 1 && ring(hc) + bps * sizeof(int) > static_cast<size_t>(kSmemBytes)) --hc;
  const int groups = (KVH + hc - 1) / hc;
  const size_t smem = ring(hc) + static_cast<size_t>(bps) * sizeof(int);
  cudaError_t err = allow_smem(paged_attn_mma<MAXKC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_mma<MAXKC><<<dim3(B * groups, S), hc * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, lengths, P, T_m, KVH, dh,
      G, g0, Gc, NB, bps, ns, scale, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge_splits<__nv_bfloat16>(partial, lengths, B, T_m, KVH, dh, G,
                                            g0, Gc, NB, bps, S, out, st);
}

}  // namespace

// q [B, KVH*G, dh]; k_pool, v_pool [P, T, KVH, dh]; tables [B, NB] i32;
// lengths [B] i32 -> out [B, KVH*G, dh], all float32 or all bfloat16;
// partial [B, KVH, S, min(G, 8), dh + 2] f32 scratch.  The table is cut
// into S splits of bps blocks (S * bps >= NB; bps a multiple of 32 / T
// where T <= 32), each staged through rings of ns (2..4) stages.  Heads run
// in launches of up to 8 a group.  B > 0, B * KVH <= 2^31 - 1,
// KVH <= 65535, S <= 65535, T >= 1, dh <= 256 and a multiple of 4
// (float32) or 16 (bfloat16), every pointer 16-byte aligned.
extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, const int* tables,
                                          const int* lengths, int B, int P,
                                          int T_m, int KVH, int dh, int G,
                                          int NB, int bps, int S, int ns,
                                          float scale, void* partial, void* out,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  for (int g0 = 0; g0 < G; g0 += kMaxGroup) {
    const int gc = G - g0 < kMaxGroup ? G - g0 : kMaxGroup;
    const int rc = dh * 4 <= 32 * 16
        ? by_group<float, 1>(q, k_pool, v_pool, tables, lengths, B, P, T_m, KVH,
                             dh, G, g0, gc, NB, bps, S, ns, scale, part, out, st)
        : by_group<float, 2>(q, k_pool, v_pool, tables, lengths, B, P, T_m, KVH,
                             dh, G, g0, gc, NB, bps, S, ns, scale, part, out, st);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, const int* tables,
                                           const int* lengths, int B, int P,
                                           int T_m, int KVH, int dh, int G,
                                           int NB, int bps, int S, int ns,
                                           float scale, void* partial, void* out,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  for (int g0 = 0; g0 < G; g0 += kMaxGroup) {
    const int gc = G - g0 < kMaxGroup ? G - g0 : kMaxGroup;
#define PAGED_MMA(KC)                                                          \
  launch_mma<KC>(q, k_pool, v_pool, tables, lengths, B, P, T_m, KVH, dh, G, g0, \
                 gc, NB, bps, S, ns, scale, part, out, st)
    const int rc = dh <= 32 ? PAGED_MMA(2) : dh <= 64 ? PAGED_MMA(4)
                 : dh <= 128 ? PAGED_MMA(8) : PAGED_MMA(16);
#undef PAGED_MMA
    if (rc != 0) return rc;
  }
  return 0;
}
