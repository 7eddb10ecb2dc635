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

// Blocks for a grid-stride loop over `work` items: enough to fill the card
// (132 SMs x 8 blocks of 256 threads = 2048 resident threads per SM on an
// H100), never more than the work needs.
inline unsigned int grid_for(int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8;
  return static_cast<unsigned int>(need < cap ? need : cap);
}

}  // namespace repro
