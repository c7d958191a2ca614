"""kmcp_tpu_torch: the PyTorch/CUDA port of kmcp-tpu.

Single-end streaming search over a one-block database, or over a
multi-block ``--block-screen --uniform-sigs`` database through the two-pass
screened search, runs on a torch device through hand-written CUDA kernels
(csrc/hash_loc.cu, csrc/count_mask.cu, csrc/pair_count.cu,
csrc/group_count.cu); every host layer (index format, FASTX, C++ natives,
FPR, TSV, engine, profile, merge) is imported from kmcp_tpu.  The package
imports torch and never jax.
"""

__version__ = "0.1.0"
