// sparse_row_update / sparse_row_update_packed: the fused CTR row step of
// every training step (paper Eq. 8, row-Adam form), in place:
//   w = f32(code) * Delta;  Adam on mu, nu (bias corrections c1, c2);
//   upd (+ wd * w);  w_new = w - lr * upd;  code' = SR(clip(w_new / Delta))
// for each slot i of the unique ids uniq[K], writing codes, mu and nu back at
// row uniq[i] and emitting w_new[i] (ALPT's Delta sub-step reads it).
//
// Replaces src/repro/kernels/sparse_row_update.py:71 `sparse_row_update`
// (Pallas TPU, pallas_call at :113) and :139 `sparse_row_update_packed`
// (pallas_call at :188).  Those walk one row per grid step, in order, with
// the ids scalar-prefetched and the scatter as an aliased output.  Here every
// slot is independent and in flight at once; the scatter is a plain store.
//
// Bound: bytes.  Per slot it reads the id, g and noise rows and writes w_new;
// per distinct row it reads and writes the codes, mu and nu and reads Delta.
// About 30 fp32 operations per element, far below the H100's ridge point.
//
// Design: one thread per byte of a row's code container.  At 8 bits a byte
// holds one code; packed at 4 or 2 bits it holds 2 or 4 codes, which the
// thread unpacks and sign-extends in registers, steps one by one and packs
// back low bits first (pad bits of a row's last byte written as zero, as
// repro_torch/core/codestore.py:pack_codes does).  d is unrestricted.
//
// Numerics: every operation is an explicit round-to-nearest intrinsic, so
// nvcc can contract nothing.  Where XLA:CPU fuses the reference's
// multiply-adds (it does, and that is where the reference's numbers come
// from), the kernel uses __fmaf_rn at the same places; see
// kernels/ref.py:adam_row_step, which this kernel equals bit for bit.  The
// float constants arrive already rounded to float32 as the reference rounds
// them (1 - b1 is computed in float64 first).
//
// Slots whose id lies outside [0, n) -- the dedup sentinel of a table with no
// scratch row -- step the clamped row min(id, n - 1), as the plain path's
// gather does, so their w_new is finite; they write nothing to the table (the
// reference's mode="drop" scatter).  When row n - 1 is also in the wave, their
// reads race with its write, so their w_new is unspecified; no caller keeps
// it.  Of a run of slots that share an in-range id (the sentinel's scratch
// row of a pad_to_tiles table) only the first writes; the others read the row
// while it is written, so their w_new, and the scratch row, are unspecified
// (finite), as the scratch row is in the reference.
#include "common.cuh"

namespace {

struct Scalars {
  float lr, c1, c2, b1, a1, b2, a2, eps, wd;
};

// One element: Adam step + SR; updates mu, nu in registers and returns the code.
__device__ __forceinline__ int step_one(int code, float st, float& mu, float& nu, float g, float u,
                                        float& w_new, const Scalars& s, float lo, float hi) {
  const float cf = static_cast<float>(code);
  const float w = __fmul_rn(cf, st);
  const float mu_new = __fmaf_rn(s.b1, mu, __fmul_rn(s.a1, g));
  const float nu_new = __fmaf_rn(s.b2, nu, __fmul_rn(s.a2, __fmul_rn(g, g)));
  const float num = __fmaf_rn(s.a1, g, __fmul_rn(s.b1, mu));
  const float den = __fmul_rn(s.c1, __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_new, s.c2)), s.eps));
  float upd = __fdiv_rn(num, den);
  if (s.wd != 0.0f) {
    upd = __fmaf_rn(s.wd, w, upd);
    w_new = __fmaf_rn(-s.lr, upd, w);
  } else {
    w_new = __fmaf_rn(cf, st, -__fmul_rn(s.lr, upd));
  }
  mu = mu_new;
  nu = nu_new;
  const float scaled = fminf(fmaxf(__fdiv_rn(w_new, st), lo), hi);
  const float base = floorf(scaled);
  const float up = (__fsub_rn(scaled, base) > u) ? 1.0f : 0.0f;
  return static_cast<int>(fminf(fmaxf(__fadd_rn(base, up), lo), hi));
}

// BITS == 8: int8 codes, one per byte.  BITS in {4, 2}: packed uint8.  The
// code range [lo, hi] comes from the table's bit width, which an int8
// container may hold below 8.
template <int BITS>
__global__ void sparse_row_update_kernel(uint8_t* __restrict__ codes, const float* __restrict__ step,
                                         float* __restrict__ mu, float* __restrict__ nu,
                                         const int32_t* __restrict__ uniq,
                                         const float* __restrict__ g_sum,
                                         const float* __restrict__ noise, float* __restrict__ w_new,
                                         int64_t n, int64_t d, int64_t k, int64_t width, Scalars s,
                                         float lo, float hi) {
  constexpr int kPerByte = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kHalf = 1 << (BITS - 1);
  const int64_t work = k * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < work;
       t += stride) {
    const int64_t slot = t / width;
    const int64_t byte = t - slot * width;
    const int64_t j0 = byte * kPerByte;
    const int64_t id = uniq[slot];
    const int64_t out = slot * d;
    // A slot writes its row if the row is in the table and the previous slot
    // holds another id: of a run of equal ids (the sentinel padding of a
    // scratch-row table) only the first writes, so the row is not contended.
    const bool live = id >= 0 && id < n && (slot == 0 || uniq[slot - 1] != id);
    const int64_t row = live ? id : (id < 0 ? 0 : n - 1);
    const float st = step[row];
    const int in = codes[row * width + byte];
    int packed = 0;
#pragma unroll
    for (int q = 0; q < kPerByte; ++q) {
      const int64_t j = j0 + q;
      if (j >= d) break;
      int code;
      if (BITS == 8) {
        code = static_cast<int8_t>(in);
      } else {
        code = (in >> (q * BITS)) & kMask;
        code = code >= kHalf ? code - (1 << BITS) : code;
      }
      float m = mu[row * d + j], v = nu[row * d + j], wn;
      const int c = step_one(code, st, m, v, g_sum[out + j], noise[out + j], wn, s, lo, hi);
      w_new[out + j] = wn;
      if (live) {
        mu[row * d + j] = m;
        nu[row * d + j] = v;
      }
      packed |= (c & kMask) << (q * BITS);
    }
    if (live) codes[row * width + byte] = static_cast<uint8_t>(BITS == 8 ? (packed & 0xff) : packed);
  }
}

}  // namespace

// codes: int8 [n, d] (container_bits == 8) or packed uint8 [n, width]
// (container_bits 4 or 2, width = ceil(d * bits / 8)); bits: the code range
// [-2^(bits-1), 2^(bits-1) - 1], 2..8; step: f32 [n]; mu, nu: f32 [n, d] (updated in
// place, as are the codes); uniq: int32 [k], ids outside [0, n) dropped; g_sum,
// noise, w_new: f32 [k, d];
// all contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int sparse_row_update_launch(void* codes, const void* step, void* mu, void* nu,
                                        const void* uniq, const void* g_sum, const void* noise,
                                        void* w_new, int64_t n, int64_t d, int64_t k,
                                        int64_t width, int container_bits, int bits, float lr, float c1, float c2,
                                        float b1, float a1, float b2, float a2, float eps,
                                        float wd, void* stream) {
  if (k * d == 0) return 0;
  if (n <= 0 || bits < 2 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  const float lo = static_cast<float>(-(1 << (bits - 1)));
  const float hi = static_cast<float>((1 << (bits - 1)) - 1);
  const auto strm = static_cast<cudaStream_t>(stream);
  const Scalars s{lr, c1, c2, b1, a1, b2, a2, eps, wd};
  const unsigned int grid = repro::grid_for(k * width);
  auto* c = static_cast<uint8_t*>(codes);
  const auto* st = static_cast<const float*>(step);
  auto* m = static_cast<float*>(mu);
  auto* v = static_cast<float*>(nu);
  const auto* ids = static_cast<const int32_t*>(uniq);
  const auto* g = static_cast<const float*>(g_sum);
  const auto* u = static_cast<const float*>(noise);
  auto* w = static_cast<float*>(w_new);
  if (container_bits == 8) {
    sparse_row_update_kernel<8><<<grid, repro::kThreads, 0, strm>>>(c, st, m, v, ids, g, u, w, n, d,
                                                                    k, width, s, lo, hi);
  } else if (container_bits == 4) {
    sparse_row_update_kernel<4><<<grid, repro::kThreads, 0, strm>>>(c, st, m, v, ids, g, u, w, n, d,
                                                                    k, width, s, lo, hi);
  } else if (container_bits == 2) {
    sparse_row_update_kernel<2><<<grid, repro::kThreads, 0, strm>>>(c, st, m, v, ids, g, u, w, n, d,
                                                                    k, width, s, lo, hi);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
