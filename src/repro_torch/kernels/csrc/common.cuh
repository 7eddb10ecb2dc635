// Shared by the port's kernel sources: each one builds into its own shared
// library with a plain C interface (kernels/_build.py binds it with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// The message for an error code a launch function returned; every library
// exports it so the Python wrapper can raise with the CUDA text.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr int kThreads = 256;

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of kThreads that the current device holds at once (2048 resident
// threads per SM on an H100).
inline int64_t resident_blocks() { return int64_t{sm_count()} * (2048 / kThreads); }

// Blocks for a grid-stride loop over `work` items: enough to fill the card,
// never more than the work needs.
inline unsigned int grid_for(int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t cap = resident_blocks();
  return static_cast<unsigned int>(need < cap ? need : cap);
}

// q = t / divisor for t < 2^31 as (umulhi(t, magic) + t) >> shift
// (Granlund & Montgomery 1994, Thm 4.2, with a 33-bit multiplier whose top
// bit is the "+ t"): the lane maps' row = task / lanes without a division.
// tests/test_torch_gather_layout.py and tests/test_torch_row_layout.py check it.
struct FastDiv {
  uint32_t magic, shift;
};

inline FastDiv fast_div(uint32_t divisor) {
  uint32_t shift = 0;
  while ((uint64_t{1} << shift) < divisor) ++shift;
  const uint64_t magic = (uint64_t{1} << 32) * ((uint64_t{1} << shift) - divisor) / divisor + 1;
  return {static_cast<uint32_t>(magic), shift};
}

__device__ __forceinline__ uint32_t divide(uint32_t t, FastDiv div) {
  return (__umulhi(t, div.magic) + t) >> div.shift;
}

// Code k of a word of BITS-bit codes packed low bits first, sign-extended:
// its field shifted to the top, then back.
template <int BITS>
__device__ __forceinline__ int32_t code_at(uint32_t word, int k) {
  return static_cast<int32_t>(word << (32 - BITS * (k + 1))) >> (32 - BITS);
}

// 16-byte cp.async (L2 only), zero-filled when !valid (rows past the data,
// columns past a row); `src` must be 16-byte aligned even then.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 on the integer pipe: round the fp32 bit pattern to 10
// explicit mantissa bits, ties away from zero (the same for finite values).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to 21 bits: hi = x rounded to TF32, lo the rounded remainder
// (x - hi is exact in fp32).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(__fsub_rn(x, __uint_as_float(hi)))};
}

// c += a b over one m16n8k8 TF32 tile, fp32 accumulate.  Lane (g, t) =
// (lane / 4, lane % 4) holds a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]} and c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
