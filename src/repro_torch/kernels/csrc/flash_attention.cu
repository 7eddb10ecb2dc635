// flash_attention_fwd: fused online-softmax attention forward with GQA,
// causal and sliding-window masks and ragged T / S,
//   o[b, t, h] = sum_s softmax_s(scale * q[b, t, h] . k[b, s, h / g]) v[b, s, h / g]
// over fp32 q [B, T, H, D] and k, v [B, S, KH, D] (g = H / KH), D a multiple
// of 8 up to 128.
//
// Replaces src/repro/kernels/flash_attention.py:88 `flash_attention_fwd`
// (Pallas TPU, pallas_call at :125), whose grid (BH, nq, nk) carries the
// accumulator, running max and denominator in VMEM scratch from one kv step
// to the next.  The mask semantics are the Pallas kernel's: key k < S, query
// q < T, q >= k when causal, q - k < window, masked scores NEG_INF = -1e30,
// the denominator clamped at 1e-20.
//
// Bound (H100 SXM data sheet).  At the LM prefill (B = 1, T = S = 157, 9/3
// heads, D = 64), bytes: q, k, v in and o out, 964,608 B, 0.288 us at 3.35
// TB/s.  At T = S = 2,048, operations: 4 per visible (query, key) pair, head
// and dimension, 4.83 G fp32 operations, 29.3 us at the 3xTF32 rate (495
// TFLOP/s of TF32 over 3 products).  The [T, S] scores never leave the SM.
//
// Design, against what the CUDA-core kernel before it lost time on:
//  * Too few warps, K/V staged once per query head.  A block holds 16
//    queries (one m16 tile per warp) of up to 8 query heads of one kv head,
//    so each K/V tile is staged once for the heads that read it; blocks run
//    longest causal footprint first.  When the (b, kv head, query tile)
//    blocks cannot fill the 132 SMs (short prompts: 30 blocks at T = 157),
//    up to 5 warp groups in the block split the query tile's kv tiles (tile
//    j to group j % groups) and group 0 folds their (o, max, sum) through
//    shared memory in group order.  Splitting across blocks instead
//    (partials in global memory merged by the last block, or a cluster
//    merging through distributed shared memory) measured slower.
//  * Register prefetch of one tile and two barriers per tile.  A 2-stage
//    cp.async ring (16-byte cp.async.cg, zero-filled past S and past D):
//    tile i + 1 lands while tile i is computed, one barrier per tile.  K
//    rows (and q's, once) are read as float2 fragments at a stride of 8 or
//    24 modulo 32 floats, V at 4 or 12 modulo 16, so a fragment read hits
//    distinct banks.
//  * Inner products as CUDA-core FMA chains bound by shared-memory reads.
//    Both run on the tensor cores at fp32 accuracy, 3xTF32 through
//    mma.sync m16n8k8: x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi)
//    (rounded on the integer pipe: equal to cvt.rna.tf32.f32, and faster
//    on the card), c += hi lo + lo hi + hi hi per k-step.  q is scaled,
//    split and stored in fragment order once per block (one 16-byte read
//    per operand and k-step).  P enters P V straight from the score
//    accumulators: each k-step's columns are permuted (2tig, 2tig + 1 -> tig,
//    tig + 4) and V's rows read in that order.  The online softmax stays
//    fp32 on the CUDA cores; the 4 lanes of a row reduce with shuffles.
//  * Tiles: 16 queries x 32 keys per warp and step; D padded to 32, 64 or
//    128 so the unrolled loops carry no bound (a runtime guard split them
//    into serial branches).  wgmma's 64-row tiles and TMA are left for long
//    T: a batch-1 prefill of 157 tokens has 10 query tiles of 16 per head.
#include "common.cuh"

#ifdef FLASH_PHASES
// Built with -DFLASH_PHASES (chip_smoke.flash_phases): thread 0 of block
// (0, 0), the longest causal footprint, stamps the SM clock at each phase.
__device__ long long flash_phases[64];
extern "C" int flash_phases_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, flash_phases, sizeof(flash_phases)));
}
#define PHASE(i)                                                                  \
  do {                                                                            \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) flash_phases[i] = clock64(); \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_tf32;
using repro::Split;
using repro::split;

constexpr int kRows = 16;    // query rows per warp (the m16 of mma.sync)
constexpr int kBk = 32;      // keys per kv tile
constexpr int kStages = 2;   // depth of the cp.async ring
constexpr int kMaxHeads = 8; // query heads per block
constexpr int kSmemLimit = 232448;  // bytes a block may opt in to on an H100
constexpr float kNegInf = -1e30f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int T, S, H, KH, D, causal, window;
  float scale;
  int heads;   // query heads per block: a divisor of g = H / KH, at most kMaxHeads
  int hsplit;  // blocks per (b, kv head) along the heads: g / heads
};

// Row strides (floats) for a padded width DP = 8 KD.  q and K rows are read
// as float2 at (row gid, column 2 tig): 8 or 24 modulo 32 puts a half-warp
// on distinct banks.  V rows are read at (key 2 tig (+1), column gid): 4 or
// 12 modulo 16 does the same for the whole warp.
__host__ __device__ constexpr int qk_stride(int dp) { return dp + (dp % 16 == 0 ? 8 : 0); }
__host__ __device__ constexpr int v_stride(int dp) { return dp + 4; }

// An A fragment (the 4 values a lane holds), split once for its products.
struct FragA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split t = split(a[i]);
    f.hi[i] = t.hi;
    f.lo[i] = t.lo;
  }
  return f;
}

// c += a b at fp32 accuracy (3xTF32): the two small cross terms first, then
// hi * hi.  b0, b1: the B fragment's 2 values.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, float b0, float b1) {
  const Split x = split(b0), y = split(b1);
  mma_tf32(c, a.hi, x.lo, y.lo);
  mma_tf32(c, a.lo, x.hi, y.hi);
  mma_tf32(c, a.hi, x.hi, y.hi);
}

// Threads a block may have: 16 warps up to D = 64, 8 above, where o's
// fragments take twice the registers.
template <int KD>
constexpr int max_threads() {
  return KD <= 8 ? 512 : 256;
}

// KD: 8-column steps of the padded head dim DP = 8 KD >= D (columns past D
// are zero in shared memory); KVS: warp groups that split a query tile's
// kv tiles (tile j goes to group j % KVS) and merge at the end.
template <int KD, int KVS>
__global__ void __launch_bounds__(max_threads<KD>())
flash_fwd_kernel(const Args a) {
  constexpr int DP = 8 * KD, KST = qk_stride(DP), VST = v_stride(DP);
  constexpr int CH = DP / 4;                      // 16-byte chunks per row
  constexpr int SUPER = KVS * kBk;                // keys per ring stage
  constexpr int STAGE = SUPER * (KST + VST);      // floats per ring stage
  extern __shared__ __align__(16) float smem[];
  PHASE(0);
  const int D = a.D, heads = a.heads;
  const int nthreads = heads * KVS * 32;
  float* qh = smem;                      // [heads * 16][KST]: q; then its TF32 parts
  float* ql = qh + heads * kRows * KST;  // [heads * 16][KST]: the rounded remainders
  float* ring = ql + heads * kRows * KST;

  const int g = a.H / a.KH;
  const int hs = blockIdx.x % a.hsplit;
  const int bk = blockIdx.x / a.hsplit;  // b * KH + kv head
  const int b = bk / a.KH, kvh = bk - b * a.KH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest footprints first
  const int h0 = kvh * g + hs * heads;                   // the block's first query head
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int hl = warp % heads, kg = warp / heads;  // head in the block, kv group

  // The block's footprint: keys [k_first, k_hi), in 32-key tiles.
  const int q_last = min(q0 + kRows, a.T) - 1;
  const int k_hi = a.causal ? min(a.S, q_last + 1) : a.S;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_first = (k_lo / kBk) * kBk;
  const int ntiles = k_hi > k_first ? (k_hi - k_first + kBk - 1) / kBk : 0;
  const int nsuper = (ntiles + KVS - 1) / KVS;

  // Ring stage js % kStages holds keys [k_first + js * SUPER, + SUPER).  A
  // thread copies one 16-byte column of every (nthreads / CH)-th row.
  const int col = 4 * (tid % CH), rstep = nthreads / CH;
  const int64_t kv_row = static_cast<int64_t>(a.KH) * D;  // floats between keys
  const int64_t kv_base = (static_cast<int64_t>(b) * a.S * a.KH + kvh) * D + col;
  auto load_stage = [&](int js) {
    float* ks = ring + (js % kStages) * STAGE + col;
    float* vs = ks + SUPER * KST;
    const int k0 = k_first + js * SUPER;
    for (int r = tid / CH; r < SUPER; r += rstep) {
      const bool ok = k0 + r < k_hi && col < D;  // keys past the footprint stay zero
      const int64_t off = ok ? kv_base + (k0 + r) * kv_row : 0;
      cp_async16(ks + r * KST, a.k + off, ok);
      cp_async16(vs + r * VST, a.v + off, ok);
    }
  };

  // q rows of the block's heads (row hl * 16 + r is query q0 + r of head h0 + hl).
  for (int i = tid; i < heads * kRows * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const int t = q0 + r % kRows;
    const bool ok = t < a.T && 4 * c < D;
    const int64_t off =
        ok ? ((static_cast<int64_t>(b) * a.T + t) * a.H + h0 + r / kRows) * D + 4 * c : 0;
    cp_async16(qh + r * KST + 4 * c, a.q + off, ok);
  }
  cp_async_commit();
  if (nsuper > 0) load_stage(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  PHASE(1);  // q has landed
  // Scale q as the plain version does, split it once for every tile, and
  // store it in A-fragment order: lane (gid, tig)'s values of head hl at
  // k-step kk, q[gid][c], q[gid + 8][c], q[gid][c + 1], q[gid + 8][c + 1]
  // (c = 8kk + 2tig), are one float4 at ((hl KD + kk) 32 + lane) 4, which S
  // reads in one load straight into the mma operand.  Warp group kg takes
  // the k-steps kk = kg (mod KVS).
  {
    constexpr int PER = (KD + KVS - 1) / KVS;
    const float* rows = qh + hl * kRows * KST;
    float4 raw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = 8 * (kg + j * KVS) + 2 * tig;
      if (kg + j * KVS < KD) {
        const float2 x0 = *reinterpret_cast<const float2*>(rows + gid * KST + c);
        const float2 x1 = *reinterpret_cast<const float2*>(rows + (gid + 8) * KST + c);
        raw[j] = make_float4(x0.x, x1.x, x0.y, x1.y);
      }
    }
    __syncthreads();  // every row is read before the fragments overwrite it
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int kk = kg + j * KVS;
      if (kk < KD) {
        const Split x = split(__fmul_rn(raw[j].x, a.scale));
        const Split y = split(__fmul_rn(raw[j].y, a.scale));
        const Split z = split(__fmul_rn(raw[j].z, a.scale));
        const Split w = split(__fmul_rn(raw[j].w, a.scale));
        const int f = ((hl * KD + kk) * 32 + lane) * 4;
        *reinterpret_cast<uint4*>(qh + f) = make_uint4(x.hi, y.hi, z.hi, w.hi);
        *reinterpret_cast<uint4*>(ql + f) = make_uint4(x.lo, y.lo, z.lo, w.lo);
      }
    }
  }

  PHASE(2);  // q is split
  // Accumulator fragments: lane (gid, tig) holds rows gid ([0], [1]) and
  // gid + 8 ([2], [3]) at columns 8n + 2tig and 8n + 2tig + 1.
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int js = 0; js < nsuper; ++js) {
    cp_async_wait<0>();
    __syncthreads();  // stage js has landed for all threads; stage js - 1 is free
    if (js + 1 < nsuper) load_stage(js + 1);
    cp_async_commit();
    if (js < 8) PHASE(8 + 4 * js);  // stage js has landed, js + 1 is issued

    const int k0 = k_first + (js * KVS + kg) * kBk;  // this group's tile
    const int q_end = q0 + kRows - 1;
    bool any = k0 < k_hi;
    if (a.causal) any = any && k0 <= q_end;
    if (a.window > 0) any = any && q0 - (k0 + kBk - 1) < a.window;
    if (!any) continue;  // no query of the tile sees a key of it
    const float* ks = ring + (js % kStages) * STAGE + kg * kBk * KST;
    const float* vs = ring + (js % kStages) * STAGE + SUPER * KST + kg * kBk * VST;

    // S = q K^T over DP in k-steps of 8.  A k-step's columns are taken in
    // the order (2tig, 2tig + 1) -> (tig, tig + 4) for q and K alike, which
    // leaves the sum unchanged and makes each K fragment one float2 read.
    float s[kBk / 8][4];
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = 8 * kk + 2 * tig, f = ((hl * KD + kk) * 32 + lane) * 4;
      const uint4 h = *reinterpret_cast<const uint4*>(qh + f);
      const uint4 l = *reinterpret_cast<const uint4*>(ql + f);
      const FragA fa = {{h.x, h.y, h.z, h.w}, {l.x, l.y, l.z, l.w}};
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(ks + (8 * n + gid) * KST + c);
        mma_3xtf32(s[n], fa, y.x, y.y);
      }
    }

    if (js < 8) PHASE(9 + 4 * js);  // S = q K^T
    // Masks, only where the tile is not wholly visible to the queries:
    // key < S, causal q >= key, window q - key < window.
    const bool full = k0 + kBk <= a.S && (!a.causal || k0 + kBk - 1 <= q0) &&
                      (a.window <= 0 || q_end - k0 < a.window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + gid + (e >> 1) * 8, kj = k0 + 8 * n + 2 * tig + (e & 1);
          const bool vis = kj < a.S && (!a.causal || qi >= kj) &&
                           (a.window <= 0 || qi - kj < a.window);
          s[n][e] = vis ? s[n][e] : kNegInf;
        }
      }
    }
    // Online softmax, fp32 on the CUDA cores, rows gid (i = 0) and gid + 8
    // (i = 1); the 4 lanes of a row reduce with shuffles.  A masked score
    // gives exp(-1e30 - m) = 0 once the row has seen a key, and a row that
    // has seen none keeps p = 0.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      const bool seen = m_new != kNegInf;
      float rsum = 0.0f;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * i + e] - m_new);
          s[n][2 * i + e] = seen ? p : 0.0f;
          rsum += s[n][2 * i + e];
        }
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l_run[i] = __fmaf_rn(l_run[i], alpha, rsum);
      m_run[i] = m_new;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][2 * i] = __fmul_rn(o[n][2 * i], alpha);
        o[n][2 * i + 1] = __fmul_rn(o[n][2 * i + 1], alpha);
      }
    }

    if (js < 8) PHASE(10 + 4 * js);  // masks and softmax
    // O += P V over the tile's keys in k-steps of 8.  P's accumulator
    // fragment of keys 8kk.. is the A fragment as it stands when key
    // 8kk + 2tig (+1) is taken as the k-step's column tig (tig + 4): V's
    // rows are read in that order, and P never leaves the registers.
#pragma unroll
    for (int kk = 0; kk < kBk / 8; ++kk) {
      const FragA fa = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* v0 = vs + (8 * kk + 2 * tig) * VST + gid;
#pragma unroll
      for (int n = 0; n < KD; ++n) mma_3xtf32(o[n], fa, v0[8 * n], v0[VST + 8 * n]);
    }
    if (js < 8) PHASE(11 + 4 * js);  // O += P V
  }
  PHASE(3);  // the kv loop is done
  cp_async_wait<0>();

  if (KVS > 1) {
    // Merge the kv groups' (o, m, l) through shared memory: the fragments
    // have one owner layout, so lane l of group kg meets lane l of group 0.
    constexpr int SLOT = 4 * KD + 4;
    __syncthreads();  // every group is done with the ring
    if (kg > 0) {
      float* r = ring + (((kg - 1) * heads + hl) * 32 + lane) * SLOT;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        *reinterpret_cast<float4*>(r + 4 * n) = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      }
      *reinterpret_cast<float4*>(r + 4 * KD) = make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int grp = 1; grp < KVS; ++grp) {
      const float* r = ring + (((grp - 1) * heads + hl) * 32 + lane) * SLOT;
      const float4 ml = *reinterpret_cast<const float4*>(r + 4 * KD);
      const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
      float fs[2], fo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], mo[i]);
        fs[i] = expf(m_run[i] - m_new);
        fo[i] = expf(mo[i] - m_new);
        l_run[i] = __fmaf_rn(l_run[i], fs[i], __fmul_rn(lo[i], fo[i]));
        m_run[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(r + 4 * n);
        o[n][0] = __fmaf_rn(o[n][0], fs[0], __fmul_rn(x.x, fo[0]));
        o[n][1] = __fmaf_rn(o[n][1], fs[0], __fmul_rn(x.y, fo[0]));
        o[n][2] = __fmaf_rn(o[n][2], fs[1], __fmul_rn(x.z, fo[1]));
        o[n][3] = __fmaf_rn(o[n][3], fs[1], __fmul_rn(x.w, fo[1]));
      }
    }
  }

  PHASE(4);  // the groups are merged
  const int h = h0 + hl;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + gid + 8 * i;
    if (qi >= a.T) continue;
    const float inv = __frcp_rn(fmaxf(l_run[i], 1e-20f));
    float* out = a.o + ((static_cast<int64_t>(b) * a.T + qi) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (8 * n < D) {
        *reinterpret_cast<float2*>(out + 8 * n + 2 * tig) =
            make_float2(__fmul_rn(o[n][2 * i], inv), __fmul_rn(o[n][2 * i + 1], inv));
      }
    }
  }
  PHASE(5);  // the output is written
}

template <int KD>
size_t smem_bytes(int heads, int kvs) {
  constexpr int DP = 8 * KD;
  return sizeof(float) * (2 * heads * kRows * qk_stride(DP) +
                          kStages * kvs * kBk * (qk_stride(DP) + v_stride(DP)));
}

template <int KD, int KVS>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<KD>(a.heads, KVS);
  if (smem > 48 * 1024) {  // above the default limit only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<KD, KVS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned int>(B * a.KH * a.hsplit),
                  static_cast<unsigned int>((a.T + kRows - 1) / kRows));
  flash_fwd_kernel<KD, KVS><<<grid, a.heads * KVS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// Warp groups that split a query tile's kv tiles: when the grid alone
// leaves most SMs idle (short prompts), one per tile of the longest
// footprint, up to 5, as far as the block's warps and shared memory allow.
template <int KD>
cudaError_t launch_kd(const Args& a, int B, cudaStream_t s) {
  const int64_t blocks = static_cast<int64_t>(B) * a.KH * a.hsplit * ((a.T + kRows - 1) / kRows);
  // Keys a query tile sees at most; a windowed footprint need not start on
  // a tile boundary.
  int keys = a.causal ? min(a.T, a.S) : a.S;
  if (a.causal && a.window > 0) keys = min(keys, a.window + kRows - 1);
  const int tiles = (keys + kBk - 1) / kBk + (a.window > 0 ? 1 : 0);
  int kvs = blocks >= repro::sm_count() ? 1 : min(5, tiles);
  while (kvs > 1 && (kvs * a.heads * 32 > max_threads<KD>() ||
                     smem_bytes<KD>(a.heads, kvs) > kSmemLimit)) {
    --kvs;
  }
  switch (kvs) {
    case 5: return launch<KD, 5>(a, B, s);
    case 4: return launch<KD, 4>(a, B, s);
    case 3: return launch<KD, 3>(a, B, s);
    case 2: return launch<KD, 2>(a, B, s);
    default: return launch<KD, 1>(a, B, s);
  }
}

}  // namespace

// q: f32 [B, T, H, D]; k, v: f32 [B, S, KH, D]; o: f32 [B, T, H, D]; all
// contiguous (16-byte aligned) on the stream's device.  H % KH == 0,
// D % 8 == 0, D <= 128; causal 0/1; window <= 0 means none.  Returns
// cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          int B, int T, int S, int H, int KH, int D, int causal,
                                          int window, float scale, void* stream) {
  if (static_cast<int64_t>(B) * T * H == 0) return 0;
  if (D <= 0 || D > 128 || D % 8 != 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(o), T, S, H, KH, D, causal, window,
         scale, 1, 1};
  // The most heads of a group that divide it and fit a block.
  const int g = H / KH;
  for (int c = g < kMaxHeads ? g : kMaxHeads; c >= 1; --c) {
    if (g % c == 0) {
      a.heads = c;
      break;
    }
  }
  a.hsplit = g / a.heads;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 32) {
    err = launch_kd<4>(a, B, st);
  } else if (D <= 64) {
    err = launch_kd<8>(a, B, st);
  } else {
    err = launch_kd<16>(a, B, st);
  }
  return static_cast<int>(err);
}
