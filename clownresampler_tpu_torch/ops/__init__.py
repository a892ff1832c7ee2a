"""Launch precompute, hand-written CUDA kernels and their plain versions, and the gather oracle."""
