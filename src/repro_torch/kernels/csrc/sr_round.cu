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
