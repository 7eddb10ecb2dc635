// flash_attention_fwd: fused online-softmax attention forward with GQA,
// causal and sliding-window masks and ragged T / S,
//   o[b, t, h] = sum_s softmax_s(scale * q[b, t, h] . k[b, s, h / g]) v[b, s, h / g]
// over fp32 q [B, T, H, D] and k, v [B, S, KH, D] (g = H / KH), D a multiple
// of 8 up to 128.
//
// Replaces src/repro/kernels/flash_attention.py:88 `flash_attention_fwd`
// (Pallas TPU, pallas_call at :128), whose grid (BH, nq, nk) carries the
// accumulator, running max and denominator in VMEM scratch from one kv step
// to the next.  Blocks on the card run in no order, so here one block owns
// one (b, h, q-tile) and a loop inside it walks the kv tiles of the tile's
// causal / window footprint (tiles outside it are never loaded).  The mask
// semantics are the Pallas kernel's: key k < S, query q < T, q >= k when
// causal, q - k < window, masked scores NEG_INF = -1e30, the denominator
// clamped at 1e-20.
//
// Bound: operations at long T (4 FLOP per visible (q, k) pair per head and
// dimension: 4.8 GFLOP at T = S = 2048, 9 heads, D = 64, causal -> ~72 us at
// 67 TFLOP/s fp32); at the LM slice's prefill (T <= 160) launch latency.
// HBM traffic is q, k, v in and o out: the [T, S] scores never leave the SM.
//
// Design (simple first, fp32 CUDA cores; no tensor cores, whose TF32 would
// break the fp32 parity):
//  * a block of 128 threads owns 32 query rows; 4 consecutive lanes share a
//    row: each computes 8 of a 32-key tile's scores (sequential __fmaf_rn
//    over D, float4 reads of the scaled q row and the k rows in shared
//    memory) and owns the row's output columns 16j + 4*lane .. + 3 in
//    registers;
//  * the q tile, the k and v tiles and the tile's probabilities live in
//    shared memory, rows padded so the lanes of a warp hit distinct banks;
//    each thread loads its share of the next kv tile (float4) into
//    registers before the current tile's arithmetic and stores it after, so
//    the loads' latency hides behind the FMAs;
//  * the row max and sum are reduced across the 4 lanes with shuffles; the
//    online-softmax state (m, l) sits in registers, replicated in the 4 lanes.
#include "common.cuh"

namespace {

constexpr int kBq = 32;         // query rows per block
constexpr int kBk = 32;         // keys per kv tile
constexpr int kLanes = 4;       // lanes per query row
constexpr int kFlashThreads = kBq * kLanes;
constexpr int kPStride = kBk + 4;  // floats; 36: float4 rows on distinct banks
constexpr float kNegInf = -1e30f;

// Whether query `qi` sees key `kj` under the Pallas kernel's masks.
__device__ __forceinline__ bool visible(int qi, int kj, int T, int S, int causal, int window) {
  bool ok = kj < S && qi < T;
  if (causal) ok = ok && qi >= kj;
  if (window > 0) ok = ok && qi - kj < window;
  return ok;
}

// NJ: float4 output columns per lane (D <= 16 * NJ).
template <int NJ>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T, int S, int H,
                 int KH, int D, int causal, int window, float scale) {
  constexpr int kTileVecs = kBk * 16 * NJ / 4 / kFlashThreads;  // float4 of a tile per thread
  extern __shared__ __align__(16) float smem[];
  const int stride = D + 4;               // q and k rows: float4-aligned, 4-bank shift
  float* qs = smem;                       // [kBq][D + 4], pre-scaled
  float* ks = qs + kBq * stride;          // [kBk][D + 4]
  float* vs = ks + kBk * stride;          // [kBk][D]
  float* ps = vs + kBk * D;               // [kBq][kPStride]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * kBq;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qi = q0 + row;
  const int dv = D / 4;  // float4 per row

  for (int i = threadIdx.x; i < kBq * dv; i += blockDim.x) {
    const int r = i / dv, c = i - r * dv;
    const int t = q0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t < T) {
      x = *reinterpret_cast<const float4*>(q + ((static_cast<int64_t>(b) * T + t) * H + h) * D +
                                           4 * c);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                      __fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(qs + r * stride + 4 * c) = x;
  }

  // The footprint of query rows [q0, q_last]: keys [k_lo, k_hi).
  const int q_last = min(q0 + kBq, T) - 1;
  const int k_hi = causal ? min(S, q_last + 1) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  // This thread's share of a kv tile: float4 i of the tile at key
  // (idx / dv), column 4 * (idx % dv).
  float4 kr[kTileVecs], vr[kTileVecs];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kTileVecs; ++i) {
      const int idx = threadIdx.x + i * kFlashThreads;
      const int r = idx / dv, s = k0 + r;
      kr[i] = vr[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < kBk && s < S) {
        const int64_t off = ((static_cast<int64_t>(b) * S + s) * KH + kvh) * D + 4 * (idx % dv);
        kr[i] = *reinterpret_cast<const float4*>(k + off);
        vr[i] = *reinterpret_cast<const float4*>(v + off);
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kTileVecs; ++i) {
      const int idx = threadIdx.x + i * kFlashThreads;
      const int r = idx / dv, c = idx % dv;
      if (r < kBk) {
        *reinterpret_cast<float4*>(ks + r * stride + 4 * c) = kr[i];
        *reinterpret_cast<float4*>(vs + r * D + 4 * c) = vr[i];
      }
    }
  };

  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m_run = kNegInf, l_run = 0.0f;

  const int k_first = (k_lo / kBk) * kBk;
  if (k_first < k_hi) load_tile(k_first);
  for (int k0 = k_first; k0 < k_hi; k0 += kBk) {
    __syncthreads();  // the previous tile's k, v and p are consumed (and q is staged)
    store_tile();
    __syncthreads();
    if (k0 + kBk < k_hi) load_tile(k0 + kBk);  // in flight during this tile's FMAs

    float sc[kBk / kLanes];
#pragma unroll
    for (int c = 0; c < kBk / kLanes; ++c) sc[c] = 0.0f;
    const float* qrow = qs + row * stride;
    for (int d = 0; d < D; d += 4) {
      const float4 qd = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int c = 0; c < kBk / kLanes; ++c) {
        const float4 kd = *reinterpret_cast<const float4*>(ks + (lane + kLanes * c) * stride + d);
        sc[c] = __fmaf_rn(qd.x, kd.x, sc[c]);
        sc[c] = __fmaf_rn(qd.y, kd.y, sc[c]);
        sc[c] = __fmaf_rn(qd.z, kd.z, sc[c]);
        sc[c] = __fmaf_rn(qd.w, kd.w, sc[c]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kBk / kLanes; ++c) {
      if (!visible(qi, k0 + lane + kLanes * c, T, S, causal, window)) sc[c] = kNegInf;
      mx = fmaxf(mx, sc[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float rsum = 0.0f;
#pragma unroll
    for (int c = 0; c < kBk / kLanes; ++c) {
      const float p =
          visible(qi, k0 + lane + kLanes * c, T, S, causal, window) ? expf(sc[c] - m_new) : 0.0f;
      ps[row * kPStride + lane + kLanes * c] = p;
      rsum += p;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l_run = __fmaf_rn(l_run, alpha, rsum);
    m_run = m_new;
    __syncwarp();  // the row's p, written by its 4 lanes, is read by all 4
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j] = make_float4(__fmul_rn(acc[j].x, alpha), __fmul_rn(acc[j].y, alpha),
                           __fmul_rn(acc[j].z, alpha), __fmul_rn(acc[j].w, alpha));
    }
    const float* prow = ps + row * kPStride;
    for (int c = 0; c < kBk; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + c);
      const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (c + e) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 16 * j + 4 * lane;
          if (col < D) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + col);
            acc[j].x = __fmaf_rn(pc[e], vv.x, acc[j].x);
            acc[j].y = __fmaf_rn(pc[e], vv.y, acc[j].y);
            acc[j].z = __fmaf_rn(pc[e], vv.z, acc[j].z);
            acc[j].w = __fmaf_rn(pc[e], vv.w, acc[j].w);
          }
        }
      }
    }
  }

  if (qi < T) {
    const float denom = fmaxf(l_run, 1e-20f);
    float* out = o + ((static_cast<int64_t>(b) * T + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 16 * j + 4 * lane;
      if (col < D) {
        *reinterpret_cast<float4*>(out + col) =
            make_float4(__fdiv_rn(acc[j].x, denom), __fdiv_rn(acc[j].y, denom),
                        __fdiv_rn(acc[j].z, denom), __fdiv_rn(acc[j].w, denom));
      }
    }
  }
}

template <int NJ>
cudaError_t launch_nj(const float* q, const float* k, const float* v, float* o, int B, int T,
                      int S, int H, int KH, int D, int causal, int window, float scale,
                      cudaStream_t s) {
  const size_t smem = sizeof(float) * (kBq * (D + 4) + kBk * (D + 4) + kBk * D + kBq * kPStride);
  if (smem > 48 * 1024) {  // above the default limit only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned int>((T + kBq - 1) / kBq), static_cast<unsigned int>(B * H));
  flash_fwd_kernel<NJ><<<grid, kFlashThreads, smem, s>>>(q, k, v, o, T, S, H, KH, D, causal,
                                                         window, scale);
  return cudaGetLastError();
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
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  cudaError_t err;
  if (D <= 32) {
    err = launch_nj<2>(qf, kf, vf, of, B, T, S, H, KH, D, causal, window, scale, st);
  } else if (D <= 64) {
    err = launch_nj<4>(qf, kf, vf, of, B, T, S, H, KH, D, causal, window, scale, st);
  } else {
    err = launch_nj<8>(qf, kf, vf, of, B, T, S, H, KH, D, causal, window, scale, st);
  }
  return static_cast<int>(err);
}
