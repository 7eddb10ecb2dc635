// dequant_matmul / dequant_matmul_packed: fused de-quantize x int8-weight matmul,
//   y[m, n] = sum_k x[m, k] * (f32(codes[n, k]) * Delta[n])
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
// 3.35 TB/s) and ~15.9 MB at 4 bits, where the 2MNK = 0.45 GFLOP of fp32
// FMAs (~6.8 us at 67 TFLOP/s) come close.
//
// Design (simple first; no tensor cores: TF32 or bf16 mma would break the
// fp32 parity with the reference):
//  * a block owns a slab of BN code rows and every row of x (up to 64 per
//    pass; blockIdx.y walks larger M in passes of 64), so each code byte is
//    read once per launch at the decode M;
//  * K is walked in chunks of 64 codes.  Each thread holds its share of the
//    next chunk's code bytes (16-byte loads; bytes where a row is not
//    16-aligned) and x values (float4 loads) in registers: the loads are
//    issued before the current chunk's FMAs and land in shared memory after
//    them, so the memory latency hides behind the arithmetic.  Packed codes
//    are unpacked to int8 in registers on the way, so int8 and packed stage
//    the same values;
//  * thread (r, g) owns code row n0 + r and x rows [g*MT, g*MT + MT): it
//    scales each code once (__fmul_rn) and accumulates with __fmaf_rn in
//    increasing k, a fixed order that does not depend on M, on the tile or
//    on the packing — so a row's logits are the same whatever else is in
//    the batch, and the packed kernel equals the int8 kernel bitwise.
#include "common.cuh"

namespace {

constexpr int kMatThreads = 128;
constexpr int kChunk = 64;    // codes of K per staged chunk
constexpr int kMPass = 64;    // rows of x per pass
constexpr int kMaxRows = 128; // code rows per block (BN <= 128)
constexpr int kCodeStride = kChunk + 4;  // bytes; 17 words: conflict-free rows
constexpr int kXVecs = kMPass * kChunk / 4 / kMatThreads;  // float4 of x per thread

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Byte `j` of `word` as a signed code.
__device__ __forceinline__ int byte_of(uint32_t word, int j) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * j)) & 0xffu));
}

// Code `c` (low bits first) of a 16-byte vector of BITS-wide fields, as int8.
template <int BITS>
__device__ __forceinline__ uint32_t code_of(const uint4& v, int c) {
  constexpr int kPerByte = 8 / BITS;
  const int b = c / kPerByte;
  const uint32_t byte = (word_of(v, b / 4) >> (8 * (b % 4))) & 0xffu;
  if constexpr (BITS == 8) {
    return byte;
  } else {
    const int f = static_cast<int>((byte >> ((c % kPerByte) * BITS)) & ((1u << BITS) - 1));
    return static_cast<uint32_t>(static_cast<uint8_t>(f >= (1 << (BITS - 1)) ? f - (1 << BITS)
                                                                              : f));
  }
}

// One thread's share of a chunk's code bytes: rows [n0, n0 + bn), codes
// [k0, k0 + kChunk), as 16-byte vectors of the row's container.
template <int BITS>
struct CodeChunk {
  static constexpr int kPerByte = 8 / BITS;
  static constexpr int kVecs = kChunk / kPerByte / 16;  // per row: 4, 2, 1
  static constexpr int kPerThread = kMaxRows * kVecs / kMatThreads;
  uint4 v[kPerThread];

  __device__ void load(const uint8_t* __restrict__ codes, int64_t n0, int bn, int64_t N,
                       int64_t width, int64_t k0, bool aligned) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * kMatThreads;
      const int r = idx / kVecs;
      const int64_t byte = k0 / kPerByte + 16 * (idx % kVecs);
      v[i] = make_uint4(0, 0, 0, 0);
      if (r >= bn || n0 + r >= N) continue;
      const uint8_t* row = codes + (n0 + r) * width;
      if (aligned && byte + 16 <= width) {
        v[i] = *reinterpret_cast<const uint4*>(row + byte);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (byte + j < width) w[j / 4] |= static_cast<uint32_t>(row[byte + j]) << (8 * (j % 4));
        }
        v[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // Unpack to int8 codes in `cs` [row][kCodeStride], four codes per word.
  __device__ void store(int8_t* cs, int bn) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * kMatThreads;
      const int r = idx / kVecs;
      if (r >= bn) continue;
      uint32_t* out = reinterpret_cast<uint32_t*>(cs + r * kCodeStride) +
                      (idx % kVecs) * 4 * kPerByte;
#pragma unroll
      for (int w = 0; w < 4 * kPerByte; ++w) {
        out[w] = code_of<BITS>(v[i], 4 * w) | code_of<BITS>(v[i], 4 * w + 1) << 8 |
                 code_of<BITS>(v[i], 4 * w + 2) << 16 | code_of<BITS>(v[i], 4 * w + 3) << 24;
      }
    }
  }
};

// One thread's share of a chunk of x: rows [m0, m0 + rows), columns
// [k0, k0 + kChunk), as float4 (zeros past M or K).
struct XChunk {
  float4 v[kXVecs];

  __device__ void load(const float* __restrict__ x, int64_t m0, int rows, int64_t M, int64_t K,
                       int64_t k0, bool aligned) {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int idx = threadIdx.x + i * kMatThreads;
      const int mi = idx / (kChunk / 4);
      const int64_t k = k0 + 4 * (idx % (kChunk / 4));
      const int64_t m = m0 + mi;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (mi >= rows || m >= M) continue;
      const float* src = x + m * K + k;
      if (aligned && k + 4 <= K) {
        v[i] = *reinterpret_cast<const float4*>(src);
      } else {
        float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k + j < K) e[j] = src[j];
        }
        v[i] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  __device__ void store(float (*xs)[kChunk], int rows) const {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int idx = threadIdx.x + i * kMatThreads;
      const int mi = idx / (kChunk / 4);
      if (mi < rows) *reinterpret_cast<float4*>(&xs[mi][4 * (idx % (kChunk / 4))]) = v[i];
    }
  }
};

template <int MT, int BITS>
__global__ void __launch_bounds__(kMatThreads)
dequant_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ step, float* __restrict__ y, int64_t M,
                      int64_t N, int64_t K, int64_t width, int bn, bool codes_aligned,
                      bool x_aligned) {
  __shared__ __align__(16) float xs[kMPass][kChunk];
  __shared__ __align__(16) int8_t cs[kMaxRows * kCodeStride];
  const int groups = kMatThreads / bn;
  const int r = threadIdx.x % bn;
  const int g = threadIdx.x / bn;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t n = n0 + r;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kMPass;
  const int rows = groups * MT;  // rows of x this block stages (<= kMPass)
  const float s = n < N ? step[n] : 0.0f;

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.0f;

  CodeChunk<BITS> cc;
  XChunk xc;
  cc.load(codes, n0, bn, N, width, 0, codes_aligned);
  xc.load(x, m0, rows, M, K, 0, x_aligned);
  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    cc.store(cs, bn);
    xc.store(xs, rows);
    __syncthreads();
    if (k0 + kChunk < K) {  // in flight during this chunk's FMAs
      cc.load(codes, n0, bn, N, width, k0 + kChunk, codes_aligned);
      xc.load(x, m0, rows, M, K, k0 + kChunk, x_aligned);
    }
    // Codes past K (the pad bits of a packed row's last byte, or past the
    // row) meet x = 0: fma(0, w, acc) == acc exactly, as acc is never -0.
    const uint32_t* crow = reinterpret_cast<const uint32_t*>(cs + r * kCodeStride);
#pragma unroll 4
    for (int j = 0; j < kChunk / 4; ++j) {
      const uint32_t q = crow[j];
      const float w0 = __fmul_rn(static_cast<float>(byte_of(q, 0)), s);
      const float w1 = __fmul_rn(static_cast<float>(byte_of(q, 1)), s);
      const float w2 = __fmul_rn(static_cast<float>(byte_of(q, 2)), s);
      const float w3 = __fmul_rn(static_cast<float>(byte_of(q, 3)), s);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[g * MT + i][4 * j]);
        acc[i] = __fmaf_rn(xv.x, w0, acc[i]);
        acc[i] = __fmaf_rn(xv.y, w1, acc[i]);
        acc[i] = __fmaf_rn(xv.z, w2, acc[i]);
        acc[i] = __fmaf_rn(xv.w, w3, acc[i]);
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int64_t m = m0 + g * MT + i;
      if (m < M) y[m * N + n] = acc[i];
    }
  }
}

template <int BITS>
cudaError_t launch_bits(const float* x, const uint8_t* codes, const float* step, float* y,
                        int64_t M, int64_t N, int64_t K, int64_t width, cudaStream_t s) {
  // Rows of x per thread (MT) and thread groups per code row (G) from the
  // rows of one pass; BN = 128 / G code rows per block.
  const int64_t rows = M < kMPass ? M : kMPass;
  const int mt = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
  const int64_t need = (rows + mt - 1) / mt;
  const int groups = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int bn = kMatThreads / groups;
  const bool codes_aligned = width % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const bool x_aligned = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>((N + bn - 1) / bn),
                  static_cast<unsigned int>((M + kMPass - 1) / kMPass));
  switch (mt) {
    case 1:
      dequant_matmul_kernel<1, BITS><<<grid, kMatThreads, 0, s>>>(x, codes, step, y, M, N, K,
                                                                   width, bn, codes_aligned,
                                                                   x_aligned);
      break;
    case 2:
      dequant_matmul_kernel<2, BITS><<<grid, kMatThreads, 0, s>>>(x, codes, step, y, M, N, K,
                                                                   width, bn, codes_aligned,
                                                                   x_aligned);
      break;
    case 4:
      dequant_matmul_kernel<4, BITS><<<grid, kMatThreads, 0, s>>>(x, codes, step, y, M, N, K,
                                                                   width, bn, codes_aligned,
                                                                   x_aligned);
      break;
    default:
      dequant_matmul_kernel<8, BITS><<<grid, kMatThreads, 0, s>>>(x, codes, step, y, M, N, K,
                                                                   width, bn, codes_aligned,
                                                                   x_aligned);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// x: f32 [M, K]; codes: int8 [N, K] (bits == 8) or packed uint8
// [N, ceil(K*bits/8)] (bits 4 or 2); step: f32 [N]; y: f32 [M, N]; all
// contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int dequant_matmul_launch(const void* x, const void* codes, const void* step, void* y,
                                     int64_t M, int64_t N, int64_t K, int bits, void* stream) {
  if (M * N == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* st = static_cast<const float*>(step);
  auto* yf = static_cast<float*>(y);
  cudaError_t err;
  if (bits == 8) {
    err = launch_bits<8>(xf, c, st, yf, M, N, K, K, s);
  } else if (bits == 4) {
    err = launch_bits<4>(xf, c, st, yf, M, N, K, (K + 1) / 2, s);
  } else if (bits == 2) {
    err = launch_bits<2>(xf, c, st, yf, M, N, K, (K + 3) / 4, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
