"""kmcp_tpu_torch: the PyTorch/CUDA port of kmcp-tpu.

Single-end streaming search over a one-block database, or over a
multi-block ``--block-screen --uniform-sigs`` database through the two-pass
screened search, runs on a torch device through hand-written CUDA kernels
(csrc/hash_loc.cu, csrc/count_mask.cu, csrc/pair_count.cu,
csrc/group_count.cu).  The host layer it needs (FASTX, k-mer hashing and
sketches, ``compute``, ``index``, the index format, FPR, TSV, the numpy
object engine and the C++ natives under csrc/host/) is the package's own
copy of kmcp_tpu's, file for file under the same paths, writing the same
bytes; so are ``merge``, ``profile`` and the ``utils`` subcommands, which
run on the host as in kmcp_tpu.  The package imports torch, never jax,
and nothing of kmcp_tpu.
"""

__version__ = "0.1.0"

# Database/index format version; the same as kmcp_tpu's, so each package
# reads the other's databases.
DB_VERSION = 1
