"""The port's kernels: CUDA sources in csrc/, wrappers, plain versions, dispatch."""
