// dequant_gather / dequant_gather_packed: fused row gather + per-row dequantize,
//   out[b, j] = f32(codes[ids[b], j]) * Delta[ids[b]]
// over int8 codes [n, d], or over a packed uint8 container [n, ceil(d*bits/8)]
// holding 2- or 4-bit codes low-bits-first (repro_torch/core/codestore.py).
//
// Replaces src/repro/kernels/dequant_gather.py:42 `dequant_gather` (Pallas TPU,
// pallas_call at :69) and :78 `dequant_gather_packed` (pallas_call at :107).
// Those scalar-prefetch the ids into SMEM and DMA one row per grid step, in
// order; here every row is independent and all of them are in flight at once.
//
// Bound: bytes.  Per id it reads the id (4 B), the row's codes (d B at 8 bits,
// ceil(d*bits/8) B packed) and Delta (4 B), and writes d fp32 (4d B).  The
// output dominates: the fp32 table never exists, only the rows asked for.
// At a serving wave (24,576 ids, d = 16) that is ~2 MB, under a microsecond
// of HBM time, so a launch is bound by launch latency in practice.
//
// Design:
//  * int8, d % 16 == 0 and aligned: one thread per 16-code chunk of a row, one
//    16-byte load of codes and four 16-byte stores of fp32 (d = 16: exactly
//    one load per row);
//  * int8 otherwise: one thread per code;
//  * packed: one thread per code, which loads its byte, shifts and masks the
//    code out low-bits-first and sign-extends it in registers.
// The multiply is a single fp32 op, so the rows equal kernels/ref.py's plain
// versions bitwise.  An id outside [0, n) writes a NaN row instead of reading
// outside the table (the serving engine rejects such ids at submit).
#include "common.cuh"

namespace {

__device__ __forceinline__ bool in_table(int32_t id, int64_t n) {
  return id >= 0 && static_cast<int64_t>(id) < n;
}

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fc00000); }

__global__ void gather_vec16_kernel(const int8_t* __restrict__ codes,
                                    const float* __restrict__ step,
                                    const int32_t* __restrict__ ids, float* __restrict__ out,
                                    int64_t n, int64_t d, int64_t b) {
  const int64_t chunks = d / 16;
  const int64_t work = b * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < work;
       t += stride) {
    const int64_t r = t / chunks;
    const int64_t c = t - r * chunks;
    const int32_t id = ids[r];
    float4* o = reinterpret_cast<float4*>(out + r * d + c * 16);
    if (!in_table(id, n)) {
      const float x = nan_value();
      for (int k = 0; k < 4; ++k) o[k] = make_float4(x, x, x, x);
      continue;
    }
    const int4 raw = *reinterpret_cast<const int4*>(codes + static_cast<int64_t>(id) * d + c * 16);
    const float s = step[id];
    const char4* q = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = make_float4(static_cast<float>(q[k].x) * s, static_cast<float>(q[k].y) * s,
                         static_cast<float>(q[k].z) * s, static_cast<float>(q[k].w) * s);
    }
  }
}

__global__ void gather_kernel(const int8_t* __restrict__ codes, const float* __restrict__ step,
                              const int32_t* __restrict__ ids, float* __restrict__ out,
                              int64_t n, int64_t d, int64_t b) {
  const int64_t work = b * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < work;
       t += stride) {
    const int64_t r = t / d;
    const int64_t j = t - r * d;
    const int32_t id = ids[r];
    out[t] = in_table(id, n)
                 ? static_cast<float>(codes[static_cast<int64_t>(id) * d + j]) * step[id]
                 : nan_value();
  }
}

template <int BITS>
__global__ void gather_packed_kernel(const uint8_t* __restrict__ packed,
                                     const float* __restrict__ step,
                                     const int32_t* __restrict__ ids, float* __restrict__ out,
                                     int64_t n, int64_t d, int64_t width, int64_t b) {
  constexpr int kPerByte = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kHalf = 1 << (BITS - 1);
  const int64_t work = b * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < work;
       t += stride) {
    const int64_t r = t / d;
    const int64_t j = t - r * d;
    const int32_t id = ids[r];
    if (!in_table(id, n)) {
      out[t] = nan_value();
      continue;
    }
    const int byte = packed[static_cast<int64_t>(id) * width + j / kPerByte];
    int v = (byte >> ((j % kPerByte) * BITS)) & kMask;
    v = v >= kHalf ? v - (1 << BITS) : v;
    out[t] = static_cast<float>(v) * step[id];
  }
}

}  // namespace

// codes: int8 [n, d]; step: f32 [n]; ids: int32 [b]; out: f32 [b, d]; all
// contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int dequant_gather_launch(const void* codes, const void* step, const void* ids,
                                     void* out, int64_t n, int64_t d, int64_t b, void* stream) {
  if (b * d == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_vec16_kernel<<<repro::grid_for(b * (d / 16)), repro::kThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(step),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), n, d, b);
  } else {
    gather_kernel<<<repro::grid_for(b * d), repro::kThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(step),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), n, d, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: uint8 [n, ceil(d*bits/8)]; bits in {2, 4}; otherwise as above.
extern "C" int dequant_gather_packed_launch(const void* packed, const void* step,
                                            const void* ids, void* out, int64_t n, int64_t d,
                                            int64_t b, int bits, void* stream) {
  if (b * d == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = repro::grid_for(b * d);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* st = static_cast<const float*>(step);
  const auto* ix = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  if (bits == 4) {
    gather_packed_kernel<4><<<grid, repro::kThreads, 0, s>>>(p, st, ix, o, n, d, (d + 1) / 2, b);
  } else if (bits == 2) {
    gather_packed_kernel<2><<<grid, repro::kThreads, 0, s>>>(p, st, ix, o, n, d, (d + 3) / 4, b);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
