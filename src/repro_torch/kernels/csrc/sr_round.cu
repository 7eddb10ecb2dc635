// sr_round: fused clip + stochastic round + int8 store (paper Eq. 1/4):
//   s = clip(w / Delta_row, lo, hi);  code = clip(floor(s) + [s - floor(s) > u], lo, hi)
//
// Replaces src/repro/kernels/sr_round.py:58 `sr_round` (the Pallas TPU kernel,
// pallas_call at :72), which tiles [r, c] into (256, 512) VMEM blocks and only
// takes shapes that are multiples of 8.  Here any shape runs: the grid-stride
// loop's bound masks the ragged tail.
//
// Bound: bytes.  Per element it reads w (4 B) and u (4 B) and writes one code
// (1 B); per row it reads Delta (4 B): 9 B/element + 4 B/row against about 8
// fp32 operations per element, far below the H100's ridge point.
//
// Design: a flat grid-stride loop over the r*c elements.  When r*c is a
// multiple of 4 and the pointers allow it, each thread takes 4 consecutive
// elements with 16-byte loads of w and u and one 4-byte store; otherwise one
// element per thread.  The row of an element comes from one division per
// thread, unsigned 32-bit while r*c < 2^31 (a 64-bit division costs several
// times the issue slots and would rival the memory time at 70M elements);
// the vector path then steps the row by counting columns.  Delta is re-read
// per row from L1/L2.
//
// sr_round_seeded (same file) replaces :87 `sr_round_seeded` (pallas_call at
// :121), which seeds the TPU's PRNG per tile.  Its noise is drawn in the
// kernel from a counter-based Philox4x32-10 (Random123's), keyed by the int32
// seed (as uint32; the second key word 0): the element at flat row-major
// index i takes word i % 4 of the block at counter (i / 4) (two low words,
// the high two 0), and u = (word >> 8) * 2^-24 from the top 24 bits of the
// word as an unsigned integer, so u lies in [0, 1) (the reference shifts a
// signed int32 and gets u in [-0.5, 0.5): ROADMAP Queue C).  One Philox call
// serves four elements, so it costs ~25 integer operations per element:
// at the int32 rate that is about as long as the 5 bytes the element moves
// (w in, code out), where sr_round moves 9.  kernels/ref.py:philox_uniform
// computes the same words in PyTorch, so the codes equal
// sr_round_seeded_ref's bit for bit.
//
// Numerics: w / Delta is __fdiv_rn (IEEE round-to-nearest whatever the
// flags; the build does not use --use_fast_math); floor, subtract, compare and
// clip are exact, and there is no multiply-add to contract.  So the codes are
// bitwise equal to kernels/ref.py's sr_round_ref and to the reference's jnp
// oracle on the same operands.
#include "common.cuh"

namespace {

__device__ __forceinline__ int8_t sr_one(float w, float step, float u, float lo, float hi) {
  const float s = fminf(fmaxf(__fdiv_rn(w, step), lo), hi);
  const float base = floorf(s);
  const float up = (s - base > u) ? 1.0f : 0.0f;
  return static_cast<int8_t>(fminf(fmaxf(base + up, lo), hi));
}

template <typename Index>
__global__ void sr_round_kernel(const float* __restrict__ w, const float* __restrict__ step,
                                const float* __restrict__ noise, int8_t* __restrict__ out,
                                Index total, Index cols, float lo, float hi) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    out[i] = sr_one(w[i], step[i / cols], noise[i], lo, hi);
  }
}

template <typename Index>
__global__ void sr_round_vec4_kernel(const float4* __restrict__ w, const float* __restrict__ step,
                                     const float4* __restrict__ noise, char4* __restrict__ out,
                                     Index total4, Index cols, float lo, float hi) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index q = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; q < total4;
       q += stride) {
    const float4 wv = w[q];
    const float4 uv = noise[q];
    Index row = (q * 4) / cols;
    Index col = q * 4 - row * cols;
    float st = step[row];
    char4 c;
    c.x = sr_one(wv.x, st, uv.x, lo, hi);
    // Elements q*4+1..q*4+3 lie before the end of the table, so stepping to
    // the next row here never reads past Delta's last entry.
    if (++col == cols) { col = 0; st = step[++row]; }
    c.y = sr_one(wv.y, st, uv.y, lo, hi);
    if (++col == cols) { col = 0; st = step[++row]; }
    c.z = sr_one(wv.z, st, uv.z, lo, hi);
    if (++col == cols) { col = 0; st = step[++row]; }
    c.w = sr_one(wv.w, st, uv.w, lo, hi);
    out[q] = c;
  }
}

// Philox4x32-10: ten rounds of two 32x32 -> 64-bit products, the key bumped
// by the Weyl constants between rounds (Salmon et al., SC'11; Random123).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// u in [0, 1) from the top 24 bits of an unsigned word (exact in float32).
__device__ __forceinline__ float uniform_of(uint32_t word) {
  return __fmul_rn(__uint2float_rn(word >> 8), 0x1p-24f);
}

// One thread per group of 4 consecutive elements (one Philox call); VEC:
// the group is whole and 16-byte aligned, loaded as a float4.
template <typename Index, bool VEC>
__global__ void sr_round_seeded_kernel(const float* __restrict__ w, const float* __restrict__ step,
                                       int8_t* __restrict__ out, Index total, Index cols,
                                       uint32_t seed, float lo, float hi) {
  const Index groups = (total + 3) / 4;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index q = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; q < groups;
       q += stride) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(static_cast<uint64_t>(q) >> 32),
                   0u, 0u),
        make_uint2(seed, 0u));
    const float u[4] = {uniform_of(r.x), uniform_of(r.y), uniform_of(r.z), uniform_of(r.w)};
    Index row = (q * 4) / cols;
    Index col = q * 4 - row * cols;
    if (VEC) {
      const float4 wv = reinterpret_cast<const float4*>(w)[q];
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      int8_t c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] = sr_one(wa[e], step[row], u[e], lo, hi);
        if (++col == cols) { col = 0; ++row; }
      }
      reinterpret_cast<char4*>(out)[q] = make_char4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Index i = q * 4 + e;
        if (i >= total) break;
        out[i] = sr_one(w[i], step[row], u[e], lo, hi);
        if (++col == cols) { col = 0; ++row; }
      }
    }
  }
}

template <typename Index>
void launch(const void* w, const void* step, const void* noise, void* out, int64_t total,
            int64_t cols, float lo, float hi, cudaStream_t stream) {
  const bool vec = total % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (vec) {
    sr_round_vec4_kernel<Index><<<repro::grid_for(total / 4), repro::kThreads, 0, stream>>>(
        static_cast<const float4*>(w), static_cast<const float*>(step),
        static_cast<const float4*>(noise), static_cast<char4*>(out),
        static_cast<Index>(total / 4), static_cast<Index>(cols), lo, hi);
  } else {
    sr_round_kernel<Index><<<repro::grid_for(total), repro::kThreads, 0, stream>>>(
        static_cast<const float*>(w), static_cast<const float*>(step),
        static_cast<const float*>(noise), static_cast<int8_t*>(out), static_cast<Index>(total),
        static_cast<Index>(cols), lo, hi);
  }
}

}  // namespace

// w, noise: f32 [rows, cols]; step: f32 [rows]; out: int8 [rows, cols]; all
// contiguous on the stream's device.  Returns cudaGetLastError().
extern "C" int sr_round_launch(const void* w, const void* step, const void* noise, void* out,
                               int64_t rows, int64_t cols, int lo, int hi, void* stream) {
  const int64_t total = rows * cols;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // Below 2^31 an unsigned 32-bit index cannot wrap when the stride is added.
  if (total < (int64_t{1} << 31)) {
    launch<uint32_t>(w, step, noise, out, total, cols, static_cast<float>(lo),
                     static_cast<float>(hi), s);
  } else {
    launch<int64_t>(w, step, noise, out, total, cols, static_cast<float>(lo),
                    static_cast<float>(hi), s);
  }
  return static_cast<int>(cudaGetLastError());
}

// w: f32 [rows, cols]; step: f32 [rows]; out: int8 [rows, cols]; seed: the
// int32 seed's bits as uint32.  All contiguous on the stream's device.
// Returns cudaGetLastError().
extern "C" int sr_round_seeded_launch(const void* w, const void* step, void* out, int64_t rows,
                                      int64_t cols, int lo, int hi, unsigned int seed,
                                      void* stream) {
  const int64_t total = rows * cols;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = repro::grid_for((total + 3) / 4);
  const bool vec = total % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const auto* wp = static_cast<const float*>(w);
  const auto* sp = static_cast<const float*>(step);
  auto* op = static_cast<int8_t*>(out);
  const float flo = static_cast<float>(lo), fhi = static_cast<float>(hi);
  // Unsigned 32-bit indices (one division per group, cheap) while the
  // largest, total + 3 + the stride, cannot wrap.
  if (total < (int64_t{1} << 31)) {
    const auto t = static_cast<uint32_t>(total), c = static_cast<uint32_t>(cols);
    if (vec) {
      sr_round_seeded_kernel<uint32_t, true><<<grid, repro::kThreads, 0, s>>>(wp, sp, op, t, c,
                                                                              seed, flo, fhi);
    } else {
      sr_round_seeded_kernel<uint32_t, false><<<grid, repro::kThreads, 0, s>>>(wp, sp, op, t, c,
                                                                               seed, flo, fhi);
    }
  } else if (vec) {
    sr_round_seeded_kernel<int64_t, true><<<grid, repro::kThreads, 0, s>>>(wp, sp, op, total,
                                                                           cols, seed, flo, fhi);
  } else {
    sr_round_seeded_kernel<int64_t, false><<<grid, repro::kThreads, 0, s>>>(wp, sp, op, total,
                                                                            cols, seed, flo, fhi);
  }
  return static_cast<int>(cudaGetLastError());
}
