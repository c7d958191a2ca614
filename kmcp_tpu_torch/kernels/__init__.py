"""Build and load plumbing for the CUDA kernels (csrc/)."""
