"""kmcp_tpu_torch: the PyTorch/CUDA port of kmcp-tpu.

Single-end streaming search over a one-block database runs on a torch
device through two hand-written CUDA kernels (csrc/hash_loc.cu,
csrc/count_mask.cu); every host layer (index format, FASTX, C++ natives,
FPR, TSV, engine, profile, merge) is imported from kmcp_tpu.  The package
imports torch and never jax.
"""

__version__ = "0.1.0"
