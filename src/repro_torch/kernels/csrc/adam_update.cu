// adam_update: one AdamW step over a list of float32 tensors (the dense
// model's parameters), out of place:
//   m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g^2
//   u  = m' / (bc1 * (sqrt(v'/bc2) + eps))  (+ wd*p);  p' = p - lr*u
//
// A helper of the training step, not the port of a TPU kernel: the
// reference's src/repro/optim/adam.py:32 `adam_update` is plain jnp that XLA
// fuses into the jitted train step.  One launch covers every tensor of the
// list (blockIdx.y picks the tensor), where the plain PyTorch version runs
// dozens of small kernels per tensor.
//
// Bound: bytes.  Each element reads p, g, m, v and writes p', m', v' (28 B)
// for about a dozen fp32 operations, far below the H100's ridge point.
//
// Numerics: the arithmetic is the reference's as XLA:CPU compiles it (see
// kernels/ref.py:adam_update_ref, which this kernel equals bit for bit): the
// moment updates and the parameter step are fused multiply-adds (__fmaf_rn),
// every other operation an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing.  The constants arrive already rounded to float32.
#include "common.cuh"

namespace {

constexpr int kMaxTensors = 24;

struct TensorList {
  const float* p[kMaxTensors];
  const float* g[kMaxTensors];
  const float* m[kMaxTensors];
  const float* v[kMaxTensors];
  float* p_out[kMaxTensors];
  float* m_out[kMaxTensors];
  float* v_out[kMaxTensors];
  int64_t n[kMaxTensors];
};

struct Scalars {
  float lr, bc1, bc2, b1, a1, b2, a2, eps, wd;
};

__global__ void adam_update_kernel(TensorList t, Scalars s) {
  const int i = blockIdx.y;
  const int64_t n = t.n[i];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float g = t.g[i][j];
    const float p = t.p[i][j];
    const float m = __fmaf_rn(s.b1, t.m[i][j], __fmul_rn(s.a1, g));
    const float v = __fmaf_rn(s.b2, t.v[i][j], __fmul_rn(s.a2, __fmul_rn(g, g)));
    float u = __fdiv_rn(m, __fmul_rn(s.bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps)));
    if (s.wd != 0.0f) u = __fmaf_rn(s.wd, p, u);
    t.p_out[i][j] = __fmaf_rn(-s.lr, u, p);
    t.m_out[i][j] = m;
    t.v_out[i][j] = v;
  }
}

}  // namespace

// count tensors; ptrs: 7 arrays of `count` device pointers, in the order p,
// g, m, v, p_out, m_out, v_out, each tensor contiguous float32 with sizes[i]
// elements (the i-th of each array alike); outputs must not alias inputs.
// Launches once per kMaxTensors tensors on `stream`.  Returns
// cudaGetLastError().
extern "C" int adam_update_launch(int count, const void* ptrs, const void* sizes, float lr,
                                  float bc1, float bc2, float b1, float a1, float b2, float a2,
                                  float eps, float wd, void* stream) {
  const auto* ptr = static_cast<void* const*>(ptrs);
  const auto* size = static_cast<const int64_t*>(sizes);
  const Scalars s{lr, bc1, bc2, b1, a1, b2, a2, eps, wd};
  const auto strm = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < count; first += kMaxTensors) {
    const int group = count - first < kMaxTensors ? count - first : kMaxTensors;
    TensorList t{};
    int64_t largest = 0;
    for (int i = 0; i < group; ++i) {
      const int k = first + i;
      t.p[i] = static_cast<const float*>(ptr[0 * count + k]);
      t.g[i] = static_cast<const float*>(ptr[1 * count + k]);
      t.m[i] = static_cast<const float*>(ptr[2 * count + k]);
      t.v[i] = static_cast<const float*>(ptr[3 * count + k]);
      t.p_out[i] = static_cast<float*>(ptr[4 * count + k]);
      t.m_out[i] = static_cast<float*>(ptr[5 * count + k]);
      t.v_out[i] = static_cast<float*>(ptr[6 * count + k]);
      t.n[i] = size[k];
      largest = size[k] > largest ? size[k] : largest;
    }
    if (largest == 0) continue;
    // Split the card's blocks between the tensors of the group.
    const unsigned int per = repro::grid_for(largest);
    const unsigned int share = (132 * 8 + group - 1) / group;
    const dim3 grid(per < share ? per : share, group);
    adam_update_kernel<<<grid, repro::kThreads, 0, strm>>>(t, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
