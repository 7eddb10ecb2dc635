// dequant_matmul / dequant_matmul_packed: fused de-quantize x int8-weight matmul,
//   y[m, n] = (sum_k x[m, k] * f32(codes[n, k])) * Delta[n]
// over int8 codes [N, K], or a packed uint8 container [N, ceil(K*bits/8)]
// holding 2- or 4-bit codes low-bits-first (repro_torch/core/codestore.py).
// The quantized LM head: N = vocab, K = d_model, M = tokens.
//
// Replaces src/repro/kernels/dequant_matmul.py:49 `dequant_matmul` (Pallas TPU,
// pallas_call at :69) and :99 `dequant_matmul_packed` (pallas_call at :118).
// Those tile (M, N, K) for the MXU and need the dims to divide the blocks
// (SmolLM's K = 576 does not divide block_k = 512, so on the TPU the
// reference falls back to its jnp oracle); this kernel takes every M, N, K.
//
// Bound: bytes at decode (M <= 8).  The codes are read once (N*K bytes at
// 8 bits, N*ceil(K*bits/8) packed) with Delta (4N), x (4MK) and y (4MN); the
// fp32 [N, K] table never exists in device memory.  At SmolLM's head
// (M = 8, N = 49,152, K = 576) that is ~30.1 MB at 8 bits (~9.0 us at
// 3.35 TB/s) and ~15.9 MB at 4 bits (~4.8 us).  The products come close:
// 2 mma.sync per 16 rows and k-step, ~442 k per call at M <= 8.
//
// Design:
//  * Products on the tensor cores at fp32 accuracy, 2xTF32.  A code (8, 4 or
//    2 bits) is exact in TF32, and Delta is applied once to each finished
//    sum, so x . c needs only x's split: x = hi + lo, hi = rna_tf32(x),
//    lo = rna_tf32(x - hi).  mma.sync.m16n8k8 takes 16 code rows as A and
//    x^T as B (n8 = 8 tokens: the decode batch; M = 1 pads B with zeros);
//    the lo and hi products accumulate in two fp32 chains, added once per
//    K-block; y = (hi + lo) * Delta.
//  * K in groups of 64 codes: lane (g, t) of a warp owns codes
//    [16t, 16t + 16) of the group in rows g and g + 8 (one 16-, 8- or 4-byte
//    shared-memory read per row), and k-step s (of 8) pairs mma column t with
//    code 16t + 2s and column t + 4 with code 16t + 2s + 1.  B uses the same
//    pairing, so a lane's x values are x[m][16t .. 16t + 16) of the group, in
//    natural order: x is split once per block into shared memory in fragment
//    order (one 16-byte read per operand and two k-steps), as flash splits q.
//  * Codes to fp32 without I2F: biased bytes (c ^ sign bit) are placed under
//    the exponent of 2^23 by PRMT (float 2^23 + c + bias) and the FADD of
//    -(2^23 + bias) leaves c exactly; 4- and 2-bit fields are first masked
//    into bytes (one LOP3 per word and field).
//  * Streaming through the TMA: a persistent grid of one block per SM; each
//    of its 8 warps walks its own 16-row tiles (tile w, w + warps, ...)
//    through its own ring of units, 16 rows x 9 groups (576 codes: 9, 4.5 or
//    2.25 KB at 8, 4, 2 bits), 2, 4 or 8 deep.  A unit that is whole rows
//    (SmolLM's K) is one contiguous cp.async.bulk; otherwise one bulk copy
//    per row; widths or pointers that are not 16-byte aligned stage the same
//    units with byte loads.  Each stage completes on its own mbarrier and
//    is refilled as soon as its unit is computed.  x comes in by bulk copies
//    too, issued before any code unit (every block waits for the same x);
//    a warp issues one unit before x lands and fills its ring after.
//  * M > 8: a block takes two n8 tiles of x where shared memory allows and
//    reuses each converted A fragment for both; larger M runs in passes
//    (blockIdx.y).  K > 1,152 runs in K-blocks whose partial sums wait in y
//    (a K-block's size depends on K alone).
//  The k order, the split and a row's arithmetic do not depend on M, on the
//  tile a row lands in or on the packing, so a row's logits are the same
//  whatever else is in the batch, and the packed kernel equals the int8
//  kernel bitwise.
#include "common.cuh"

#ifdef HEAD_PHASES
// Built with -DHEAD_PHASES (chip_smoke.head_phases): lane 0 of warp 0 of
// block (0, 0) stamps the SM clock at each phase.
__device__ long long head_phases[64];
extern "C" int head_phases_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, head_phases, sizeof(head_phases)));
}
#define PHASE(i)                                                                  \
  do {                                                                            \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) head_phases[i] = clock64(); \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

using repro::mma_tf32;
using repro::Split;
using repro::split;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 64;     // codes per group: 16 per lane column t, 8 k-steps
constexpr int kBlockK = 1152;  // codes of K per K-block (x of a K-block in shared memory)
constexpr int kSmemLimit = 232448;  // bytes a block may opt in to on an H100

// A row's bytes for BITS: kLane per lane and group (its 16 codes), kRow per
// group; a ring unit holds kGroups groups of 16 rows at a row stride of
// kStride bytes (kGroups odd: the 8 rows g of a fragment read fall on
// distinct banks), kStages units per warp (147,456 bytes for 8 warps).
template <int BITS>
struct Layout {
  static constexpr int kLane = 2 * BITS;
  static constexpr int kRow = 4 * kLane;
  static constexpr int kGroups = 9;
  static constexpr int kStride = kGroups * kRow;  // 576, 288, 144
  static constexpr int kStage = 16 * kStride;
  static constexpr int kStages = 16 / BITS;       // 2, 4, 8
};

struct Args {
  const float* x;
  const uint8_t* codes;
  const float* step;
  float* y;
  int64_t M, N, K, width;
  int Kp;  // K rounded up to a group (at least one)
  int codes_aligned, x_aligned;
};

// Byte `e` of `biased` (a code plus its bias) as the exact fp32 code.
__device__ __forceinline__ uint32_t code_f32(uint32_t biased, int e, float magic) {
  return __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | e)), magic));
}

// One lane's 16 codes of one row and group, as stored: 16, 8 or 4 bytes.
template <int BITS>
__device__ __forceinline__ uint4 load_codes(const uint8_t* p) {
  if constexpr (BITS == 8) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (BITS == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_uint4(v.x, v.y, 0, 0);
  } else {
    return make_uint4(*reinterpret_cast<const uint32_t*>(p), 0, 0, 0);
  }
}

// Those codes as fp32 bit patterns, in the lane's code order: c[i] is code
// 16t + i of the group.
template <int BITS>
__device__ __forceinline__ void convert(const uint4 v, uint32_t (&c)[16]) {
  if constexpr (BITS == 8) {
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = code_f32(w[i / 4], i % 4, 8388736.0f);  // 2^23 + 128
  } else if constexpr (BITS == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = (h == 0 ? v.x : v.y) ^ 0x88888888u;
      const uint32_t lo = b & 0x0F0F0F0Fu, hi = (b >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // byte e: codes 2e (low nibble) and 2e + 1
        c[8 * h + 2 * e] = code_f32(lo, e, 8388616.0f);  // 2^23 + 8
        c[8 * h + 2 * e + 1] = code_f32(hi, e, 8388616.0f);
      }
    }
  } else {
    const uint32_t b = v.x ^ 0xAAAAAAAAu;
#pragma unroll
    for (int f = 0; f < 4; ++f) {  // field f of byte e: code 4e + f
      const uint32_t field = (b >> (2 * f)) & 0x03030303u;
#pragma unroll
      for (int e = 0; e < 4; ++e) c[4 * e + f] = code_f32(field, e, 8388610.0f);  // 2^23 + 2
    }
  }
}

// mbarrier and 1-D bulk copy (TMA) helpers, CTA scope.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
// The one arrival of a phase, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16; both ends 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads, 1) dequant_matmul_kernel(const Args a) {
  using L = Layout<BITS>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kb_max = a.Kp < kBlockK ? a.Kp : kBlockK;
  // x of the pass's rows and the current K-block, split, in fragment order:
  // float4 ((t * ngb + g) * 4 + j) * 32 + lane holds x[8t + gid][64g + 16tig
  // + 4j .. + 4) (tile t, group g), hi parts in xh, lo parts in xl (which
  // first receives the raw rows of x: 8 MT rows of kb_max floats).  Then
  // each warp's ring, its mbarriers and x's.
  float4* xh = reinterpret_cast<float4*>(smem);
  float4* xl = xh + MT * (kb_max / kGroup) * 128;
  float* x_raw = reinterpret_cast<float*>(xl);
  uint8_t* rings = reinterpret_cast<uint8_t*>(xl + MT * (kb_max / kGroup) * 128);
  uint8_t* ring = rings + warp * S * L::kStage;
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(rings + kWarps * S * L::kStage);
  uint64_t* bars = x_bar + 1 + warp * S;

  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * 8 * MT;
  const int rows_x = a.M - m0 < 8 * MT ? static_cast<int>(a.M - m0) : 8 * MT;
  const int tiles = static_cast<int>((a.N + 15) / 16);
  const int wstride = gridDim.x * kWarps;  // the warp's tiles: w0, w0 + wstride, ...
  const int w0 = blockIdx.x * kWarps + warp;
  PHASE(0);
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s);
    if (warp == 0) mbar_init(x_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int issued = 0, consumed = 0;  // the warp's units so far, over all K-blocks

  for (int kb0 = 0, kb = 0; kb0 < a.Kp; kb0 += kBlockK, ++kb) {
    const int ngb = (a.Kp - kb0 < kBlockK ? a.Kp - kb0 : kBlockK) / kGroup;
    const int nch = (ngb + L::kGroups - 1) / L::kGroups;  // units per tile
    const bool last_kb = kb0 + kBlockK >= a.Kp;
    const int kx = a.K - kb0 < ngb * kGroup ? static_cast<int>(a.K - kb0) : ngb * kGroup;
    if (kb > 0) __syncthreads();  // every warp is done with the previous K-block's x

    // x's rows of this K-block, raw, by bulk copies, issued before any code
    // unit: the SM's bulk copies share one queue, and every block waits for x.
    if (a.x_aligned && warp == 0) {
      if (lane == 0) mbar_arrive_expect(x_bar, static_cast<uint32_t>(rows_x * kx * 4));
      if (lane < rows_x && kx > 0) {
        bulk_copy(x_raw + lane * ngb * kGroup, a.x + (m0 + lane) * a.K + kb0,
                  static_cast<uint32_t>(kx * 4), x_bar);
      }
    }
    __syncthreads();

    // Unit of the warp: its tile it_t, groups [it_c kGroups, + kGroups) of
    // the K-block, into stage issued % S, completing on the stage's mbarrier.
    int it_t = w0, it_c = 0;  // the next unit to issue: tile, chunk
    auto issue = [&]() {
      if (it_t >= tiles) return;
      const int64_t n0 = 16 * static_cast<int64_t>(it_t);
      const int g0 = it_c * L::kGroups;
      const int bytes = (ngb - g0 < L::kGroups ? ngb - g0 : L::kGroups) * L::kRow;
      const int64_t off0 = static_cast<int64_t>(kb0 / kGroup + g0) * L::kRow;
      const int stage = issued % S;
      uint8_t* st = ring + stage * L::kStage;
      const int rows = a.N - n0 < 16 ? static_cast<int>(a.N - n0) : 16;
      // Bytes of the unit inside a row.  Groups past the row's width (the
      // pad up to a group) keep what the stage held: finite codes that meet
      // x = 0.  Rows past N are never written out.
      const int64_t room = a.width - off0;
      const int size = room <= 0 ? 0 : room < bytes ? static_cast<int>(room) : bytes;
      if (a.codes_aligned && a.width == L::kStride) {  // whole rows: one copy
        if (lane == 0) {
          mbar_arrive_expect(bars + stage, static_cast<uint32_t>(rows * size));
          bulk_copy(st, a.codes + n0 * a.width, static_cast<uint32_t>(rows * size),
                    bars + stage);
        }
      } else if (a.codes_aligned) {  // one copy per row
        if (lane == 0) mbar_arrive_expect(bars + stage, static_cast<uint32_t>(rows * size));
        if (lane < rows && size > 0) {
          bulk_copy(st + lane * L::kStride, a.codes + (n0 + lane) * a.width + off0,
                    static_cast<uint32_t>(size), bars + stage);
        }
      } else {  // ragged rows: the same unit through byte loads
#pragma unroll 1
        for (int p = lane; p < 16 * L::kStride; p += 32) {
          const int r = p / L::kStride, b = p % L::kStride;
          if (r < rows && b < size) {
            st[r * L::kStride + b] = a.codes[(n0 + r) * a.width + off0 + b];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive_expect(bars + stage, 0);
      }
      if (++it_c == nch) it_c = 0, it_t += wstride;
      ++issued;
    };
    issue();  // one unit now; the rest of the ring once x is in

    // Split the pass's rows of x (zeros past M and K) into fragment order:
    // a thread's slots share j = (tid / 32) % 4 and lane; (t, g) advances by
    // two groups per 256 slots.  The raw rows are read before any lo part
    // overwrites them.
    constexpr int kSlots = (MT * kBlockK / kGroup * 128 + kThreads - 1) / kThreads;
    float4 v[kSlots];
    {
      if (a.x_aligned) mbar_wait(x_bar, kb & 1);
      const int j = (tid / 32) % 4;
      int t = 0, g = tid / 128;
      while (g >= ngb && t < MT) g -= ngb, ++t;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int f = tid + i * kThreads;
        if (f >= MT * ngb * 128) break;
        const int ml = 8 * t + gid, kl = kGroup * g + 16 * tig + 4 * j;
        float e[4];
        if (a.x_aligned) {
          const float4 r = ml < rows_x && kl < kx
                               ? *reinterpret_cast<const float4*>(x_raw + ml * ngb * kGroup + kl)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          e[0] = r.x, e[1] = r.y, e[2] = r.z, e[3] = r.w;
        } else {
          const float* src = a.x + (m0 + ml) * a.K + kb0 + kl;
#pragma unroll
          for (int q = 0; q < 4; ++q) e[q] = ml < rows_x && kl + q < kx ? src[q] : 0.0f;
        }
        v[i] = make_float4(e[0], e[1], e[2], e[3]);
        for (g += 2; g >= ngb && t < MT;) g -= ngb, ++t;
      }
    }
    PHASE(1);  // x has landed
    __syncthreads();  // the raw rows are read
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int f = tid + i * kThreads;
      if (f >= MT * ngb * 128) break;
      const Split s0 = split(v[i].x), s1 = split(v[i].y), s2 = split(v[i].z),
                  s3 = split(v[i].w);
      xh[f] = make_float4(__uint_as_float(s0.hi), __uint_as_float(s1.hi),
                          __uint_as_float(s2.hi), __uint_as_float(s3.hi));
      xl[f] = make_float4(__uint_as_float(s0.lo), __uint_as_float(s1.lo),
                          __uint_as_float(s2.lo), __uint_as_float(s3.lo));
    }
    __syncthreads();
    PHASE(2);  // x is split
#pragma unroll 1
    for (int u = 1; u < S; ++u) issue();

    float acc_h[MT][4], acc_l[MT][4];  // tile t's hi and lo products
    float sa = 1.0f, sb = 1.0f;         // Delta of the lane's rows, read as a tile starts
    for (int u = 0, tile = w0, c = 0; tile < tiles; ++u) {
      const int stage = consumed % S;
      mbar_wait(bars + stage, (consumed / S) & 1);
      ++consumed;
      if (u < 18) PHASE(8 + 3 * u);  // unit u has landed
      const int64_t n0 = 16 * static_cast<int64_t>(tile);
      const int64_t na = n0 + gid, nb = n0 + gid + 8;  // the lane's rows of y
      if (c == 0) {  // a tile starts: from zero, or from the previous K-blocks' sums
        if (last_kb) {
          sa = na < a.N ? a.step[na] : 1.0f;
          sb = nb < a.N ? a.step[nb] : 1.0f;
        }
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t m = m0 + 8 * t + 2 * tig + (e & 1), n = e < 2 ? na : nb;
            acc_h[t][e] = kb0 > 0 && m < a.M && n < a.N ? a.y[m * a.N + n] : 0.0f;
            acc_l[t][e] = 0.0f;
          }
        }
      }
      const uint8_t* st = ring + stage * L::kStage + tig * L::kLane;
      const int g0 = c * L::kGroups;
      const int ng = ngb - g0 < L::kGroups ? ngb - g0 : L::kGroups;
      uint4 next_a = load_codes<BITS>(st + gid * L::kStride);
      uint4 next_b = load_codes<BITS>(st + (gid + 8) * L::kStride);
      for (int g = 0; g < ng; ++g) {
        uint32_t ca[16], cb[16];  // the lane's codes of rows gid and gid + 8
        convert<BITS>(next_a, ca);
        convert<BITS>(next_b, cb);
        if (g + 1 < ng) {  // the next group's codes, read during this one's products
          next_a = load_codes<BITS>(st + gid * L::kStride + (g + 1) * L::kRow);
          next_b = load_codes<BITS>(st + (gid + 8) * L::kStride + (g + 1) * L::kRow);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // k-steps 2j and 2j + 1
          const uint32_t a0[4] = {ca[4 * j], cb[4 * j], ca[4 * j + 1], cb[4 * j + 1]};
          const uint32_t a1[4] = {ca[4 * j + 2], cb[4 * j + 2], ca[4 * j + 3], cb[4 * j + 3]};
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            const int f = ((t * ngb + g0 + g) * 4 + j) * 32 + lane;
            const float4 h = xh[f], l = xl[f];
            mma_tf32(acc_l[t], a0, __float_as_uint(l.x), __float_as_uint(l.y));
            mma_tf32(acc_h[t], a0, __float_as_uint(h.x), __float_as_uint(h.y));
            mma_tf32(acc_l[t], a1, __float_as_uint(l.z), __float_as_uint(l.w));
            mma_tf32(acc_h[t], a1, __float_as_uint(h.z), __float_as_uint(h.w));
          }
        }
      }
      __syncwarp();  // every lane is done with the stage: refill it
      issue();
      if (u < 18) PHASE(9 + 3 * u);  // unit u is computed
      if (++c == nch) {  // the tile's K-block is done: y = (hi + lo) * Delta at the end
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t m = m0 + 8 * t + 2 * tig + (e & 1), n = e < 2 ? na : nb;
            const float sum = __fadd_rn(acc_h[t][e], acc_l[t][e]);
            if (m < a.M && n < a.N) a.y[m * a.N + n] = last_kb ? __fmul_rn(sum, e < 2 ? sa : sb)
                                                               : sum;
          }
        }
        c = 0, tile += wstride;
      }
      if (u < 18) PHASE(10 + 3 * u);  // unit u is written out
    }
  }
  PHASE(3);  // the warp is done
}

template <int BITS>
size_t smem_bytes(int mt, int kp) {
  using L = Layout<BITS>;
  const int kb = kp < kBlockK ? kp : kBlockK;
  return static_cast<size_t>(mt) * kb * 64 +
         static_cast<size_t>(kWarps) * L::kStages * (L::kStage + sizeof(uint64_t)) +
         sizeof(uint64_t);
}

template <int BITS, int MT>
cudaError_t launch(const Args& a, int sms, cudaStream_t s) {
  const size_t smem = smem_bytes<BITS>(MT, a.Kp);
  const cudaError_t err = cudaFuncSetAttribute(
      dequant_matmul_kernel<BITS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (a.N + 15) / 16;
  const int64_t blocks = (tiles + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned int>(blocks < sms ? blocks : sms),
                  static_cast<unsigned int>((a.M + 8 * MT - 1) / (8 * MT)));
  dequant_matmul_kernel<BITS, MT><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// n8 tiles of x per pass: two where M needs them and shared memory allows,
// else one; larger M runs in passes.
template <int BITS>
cudaError_t launch_bits(const Args& a, int sms, cudaStream_t s) {
  if (a.M > 8 && smem_bytes<BITS>(2, a.Kp) <= kSmemLimit) return launch<BITS, 2>(a, sms, s);
  return launch<BITS, 1>(a, sms, s);
}

}  // namespace

// x: f32 [M, K]; codes: int8 [N, K] (bits == 8) or packed uint8
// [N, ceil(K*bits/8)] (bits 4 or 2); step: f32 [N]; y: f32 [M, N]; all
// contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int dequant_matmul_launch(const void* x, const void* codes, const void* step, void* y,
                                     int64_t M, int64_t N, int64_t K, int bits, void* stream) {
  if (M * N == 0) return 0;
  if (bits != 8 && bits != 4 && bits != 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
         static_cast<const float*>(step), static_cast<float*>(y), M, N, K,
         (K * bits + 7) / 8, 0, 0, 0};
  a.Kp = static_cast<int>(((K > 0 ? K : 1) + kGroup - 1) / kGroup * kGroup);
  a.codes_aligned = a.width % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  a.x_aligned = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    err = launch_bits<8>(a, sms, s);
  } else if (bits == 4) {
    err = launch_bits<4>(a, sms, s);
  } else {
    err = launch_bits<2>(a, sms, s);
  }
  return static_cast<int>(err);
}
