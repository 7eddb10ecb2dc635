// lpt_fused_update / lpt_fused_update_packed: the dense LPT write-back of
// every LM training step (paper Eq. 8 in one pass), per element of [R, C]:
//   w = f32(code) * Delta_row;  upd' = upd + wd * w (wd != 0);
//   w' = w - lr * upd';  s = clip(w' / Delta'_row, lo, hi);
//   code' = clip(floor(s) + [s - floor(s) > u], lo, hi)
// with the optimizer direction `upd` formed outside, Delta' ALPT's new step
// (Delta when there is none) and u the SR noise operand.
//
// Replaces src/repro/kernels/lpt_update.py:50 `lpt_fused_update` (Pallas TPU,
// pallas_call at :72, (256, 512) VMEM tiles) and :93 `lpt_fused_update_packed`
// (pallas_call at :123, full-width row tiles).  Those take only shapes that
// divide their tiles; here any R and C run, and packed rows of any width.
//
// Bound: bytes.  Per element it reads the code (1 B, or bits/8 packed), upd
// and u (8 B) and writes the new code; per row Delta and Delta' (8 B).  About
// 10 fp32 operations per element, far below the H100's ridge point.
//
// Design: int8 codes -- a flat grid-stride loop, 4 consecutive elements per
// thread with 16-byte loads of upd and u and 4-byte loads and stores of the
// codes when R*C is a multiple of 4 and the pointers allow it, one element
// per thread otherwise; the row of an element comes from one division, as in
// sr_round.cu.  Packed codes -- one thread per byte of a row's container: it
// unpacks 2 or 4 codes (low bits first, sign-extended, as
// repro_torch/core/codestore.py), steps each, and packs them back with the
// pad bits of a row's last byte zero, so the bytes equal
// pack(lpt_fused_update(unpack(...))).
//
// Numerics: every operation is an explicit round-to-nearest intrinsic, so
// nvcc contracts nothing.  The reference's numbers are XLA:CPU's (its Pallas
// body interpreted, and its jnp oracle jitted, both contract the same way):
// without decay w' = fma(code, Delta, -(lr * upd)), with decay
// upd' = fma(wd, w, upd), w' = fma(-lr, upd', w).  The kernel uses __fmaf_rn
// exactly there, so it equals kernels/ref.py:lpt_fused_update_ref bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ int step_one(int code, float st, float ns, float g, float u, float lr,
                                        float wd, float lo, float hi) {
  const float cf = static_cast<float>(code);
  float w_new;
  if (wd != 0.0f) {
    const float w = __fmul_rn(cf, st);
    w_new = __fmaf_rn(-lr, __fmaf_rn(wd, w, g), w);
  } else {
    w_new = __fmaf_rn(cf, st, -__fmul_rn(lr, g));
  }
  const float s = fminf(fmaxf(__fdiv_rn(w_new, ns), lo), hi);
  const float base = floorf(s);
  const float up = (__fsub_rn(s, base) > u) ? 1.0f : 0.0f;
  return static_cast<int>(fminf(fmaxf(__fadd_rn(base, up), lo), hi));
}

struct Args {
  float lr, wd, lo, hi;
};

template <typename Index>
__global__ void lpt_update_kernel(const int8_t* __restrict__ codes, const float* __restrict__ step,
                                  const float* __restrict__ new_step, const float* __restrict__ upd,
                                  const float* __restrict__ noise, int8_t* __restrict__ out,
                                  Index total, Index cols, Args a) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const Index row = i / cols;
    out[i] = static_cast<int8_t>(step_one(codes[i], step[row], new_step[row], upd[i], noise[i],
                                          a.lr, a.wd, a.lo, a.hi));
  }
}

template <typename Index>
__global__ void lpt_update_vec4_kernel(const char4* __restrict__ codes,
                                       const float* __restrict__ step,
                                       const float* __restrict__ new_step,
                                       const float4* __restrict__ upd,
                                       const float4* __restrict__ noise, char4* __restrict__ out,
                                       Index total4, Index cols, Args a) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index q = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; q < total4;
       q += stride) {
    const char4 cv = codes[q];
    const float4 gv = upd[q];
    const float4 uv = noise[q];
    Index row = (q * 4) / cols;
    Index col = q * 4 - row * cols;
    float st = step[row], ns = new_step[row];
    char4 o;
    o.x = static_cast<signed char>(step_one(cv.x, st, ns, gv.x, uv.x, a.lr, a.wd, a.lo, a.hi));
    // Elements q*4+1..q*4+3 lie before the end of the table, so stepping to
    // the next row here never reads past Delta's last entry.
    if (++col == cols) { col = 0; ++row; st = step[row]; ns = new_step[row]; }
    o.y = static_cast<signed char>(step_one(cv.y, st, ns, gv.y, uv.y, a.lr, a.wd, a.lo, a.hi));
    if (++col == cols) { col = 0; ++row; st = step[row]; ns = new_step[row]; }
    o.z = static_cast<signed char>(step_one(cv.z, st, ns, gv.z, uv.z, a.lr, a.wd, a.lo, a.hi));
    if (++col == cols) { col = 0; ++row; st = step[row]; ns = new_step[row]; }
    o.w = static_cast<signed char>(step_one(cv.w, st, ns, gv.w, uv.w, a.lr, a.wd, a.lo, a.hi));
    out[q] = o;
  }
}

// BITS in {4, 2}: one thread per byte of the packed container [rows, width].
template <typename Index, int BITS>
__global__ void lpt_update_packed_kernel(const uint8_t* __restrict__ packed,
                                         const float* __restrict__ step,
                                         const float* __restrict__ new_step,
                                         const float* __restrict__ upd,
                                         const float* __restrict__ noise,
                                         uint8_t* __restrict__ out, Index rows, Index cols,
                                         Index width, Args a) {
  constexpr int kPerByte = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kHalf = 1 << (BITS - 1);
  const Index work = rows * width;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index t = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; t < work;
       t += stride) {
    const Index row = t / width;
    const Index byte = t - row * width;
    const float st = step[row], ns = new_step[row];
    const int in = packed[t];
    const Index base = row * cols + byte * kPerByte;
    int res = 0;
#pragma unroll
    for (int q = 0; q < kPerByte; ++q) {
      if (byte * kPerByte + q >= cols) break;
      int code = (in >> (q * BITS)) & kMask;
      code = code >= kHalf ? code - (1 << BITS) : code;
      const int c = step_one(code, st, ns, upd[base + q], noise[base + q], a.lr, a.wd, a.lo, a.hi);
      res |= (c & kMask) << (q * BITS);
    }
    out[t] = static_cast<uint8_t>(res);
  }
}

template <typename Index>
void launch_packed(int bits, const void* packed, const float* step, const float* new_step,
                   const void* upd, const void* noise, void* out, int64_t rows, int64_t cols,
                   int64_t width, Args a, cudaStream_t stream) {
  const unsigned int grid = repro::grid_for(rows * width);
  const auto* in = static_cast<const uint8_t*>(packed);
  const auto* g = static_cast<const float*>(upd);
  const auto* u = static_cast<const float*>(noise);
  auto* o = static_cast<uint8_t*>(out);
  const auto r = static_cast<Index>(rows), c = static_cast<Index>(cols);
  const auto w = static_cast<Index>(width);
  if (bits == 4) {
    lpt_update_packed_kernel<Index, 4><<<grid, repro::kThreads, 0, stream>>>(in, step, new_step,
                                                                             g, u, o, r, c, w, a);
  } else {
    lpt_update_packed_kernel<Index, 2><<<grid, repro::kThreads, 0, stream>>>(in, step, new_step,
                                                                             g, u, o, r, c, w, a);
  }
}

template <typename Index>
void launch_int8(const void* codes, const float* step, const float* new_step, const void* upd,
                 const void* noise, void* out, int64_t total, int64_t cols, Args a,
                 cudaStream_t stream) {
  const bool vec = total % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (vec) {
    lpt_update_vec4_kernel<Index><<<repro::grid_for(total / 4), repro::kThreads, 0, stream>>>(
        static_cast<const char4*>(codes), step, new_step, static_cast<const float4*>(upd),
        static_cast<const float4*>(noise), static_cast<char4*>(out),
        static_cast<Index>(total / 4), static_cast<Index>(cols), a);
  } else {
    lpt_update_kernel<Index><<<repro::grid_for(total), repro::kThreads, 0, stream>>>(
        static_cast<const int8_t*>(codes), step, new_step, static_cast<const float*>(upd),
        static_cast<const float*>(noise), static_cast<int8_t*>(out), static_cast<Index>(total),
        static_cast<Index>(cols), a);
  }
}

}  // namespace

// codes: int8 [rows, cols] (container_bits == 8) or packed uint8 [rows, width]
// (container_bits 4 or 2, width = ceil(cols * bits / 8)); out: the same
// container, written whole; step, new_step: f32 [rows] (new_step may be step);
// upd, noise: f32 [rows, cols]; bits: the code range [-2^(bits-1),
// 2^(bits-1) - 1], 2..8; lr, wd: float32 by value.  All contiguous on the
// stream's device.  Returns cudaGetLastError().
extern "C" int lpt_update_launch(const void* codes, const void* step, const void* new_step,
                                 const void* upd, const void* noise, void* out, int64_t rows,
                                 int64_t cols, int64_t width, int container_bits, int bits,
                                 float lr, float wd, void* stream) {
  if (rows * cols == 0) return 0;
  if (bits < 2 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lr, wd, static_cast<float>(-(1 << (bits - 1))),
               static_cast<float>((1 << (bits - 1)) - 1)};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(step);
  const auto* ns = static_cast<const float*>(new_step);
  if (container_bits == 8) {
    const int64_t total = rows * cols;
    // Below 2^31 an unsigned 32-bit index cannot wrap when the stride is added.
    if (total < (int64_t{1} << 31)) {
      launch_int8<uint32_t>(codes, st, ns, upd, noise, out, total, cols, a, s);
    } else {
      launch_int8<int64_t>(codes, st, ns, upd, noise, out, total, cols, a, s);
    }
  } else if (container_bits == 4 || container_bits == 2) {
    // The element index rows * cols bounds every index the kernel forms.
    if (rows * cols < (int64_t{1} << 31)) {
      launch_packed<uint32_t>(container_bits, codes, st, ns, upd, noise, out, rows, cols, width,
                              a, s);
    } else {
      launch_packed<int64_t>(container_bits, codes, st, ns, upd, noise, out, rows, cols, width, a,
                             s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
