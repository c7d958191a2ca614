"""Multi-device sharded search: the (d, t) mesh and the sharded count step.

Port of kmcp_tpu/parallel/sharding.py.  The reference scales by sharding
the database into independent sub-DBs, one ``kmcp search`` a node, and
merging the TSVs offline.  Here that is one program over a ``("d", "t")``
DeviceMesh of ranks (one process and one device a rank):

- axis ``d``: data parallelism over the read batch;
- axis ``t``: the bit matrix sharded by target words, so each rank
  gathers rows from its own shard only;
- cross-shard results (per-query matched targets, the global best target)
  reduce over ``t`` with collectives: the in-program ``kmcp merge``.

The search tails on a mesh are ``device_step.sharded_count_tail`` and
``screen.sharded_screened_tail``, which ``TorchDeviceDB(mesh=...)`` runs.
Bloom-row positions of ``host_locations`` are derived on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..search.count import count_mask
from ..search.device_step import (
    all_gather_cat,
    global_target_ids,
    mesh_place,
)
from .distributed import mesh_device_type

MIN_COUNT = 10  # the JAX step's fixed threshold (sharding.py:67)


def make_mesh(n_devices: int | None = None,
              data_parallel: int | None = None, device=None):
    """A (d, t) DeviceMesh over the world's ranks, with the JAX package's
    default d: 2 when the rank count is even and at least 4, else 1
    (sharding.py:26-44).  Without ``device`` every rank needs a card of its
    own, and too few cards raise: there is no fall-back to the CPU.  A
    caller that means to share a card (or the CPU) names the ranks' device,
    e.g. device="cuda:0" with backend "gloo"."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, the "
                         f"world has {world}")
    if device is None and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"{n} ranks and {torch.cuda.device_count()} CUDA cards: name the "
            "ranks' device to share one (device='cuda:0' with backend "
            "'gloo') or the CPU (device='cpu')")
    if data_parallel is None:
        data_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    if n % data_parallel:
        raise ValueError(f"d={data_parallel} does not divide {n} ranks")
    return init_device_mesh(mesh_device_type(),
                            (data_parallel, n // data_parallel),
                            mesh_dim_names=("d", "t"))


def make_sharded_search_step(mesh, num_hashes: int = 1):
    """The sharded count step of the JAX package (sharding.py:47-96), as a
    function of this rank's tensors:

      bits [S+1, W_t] int32 (``distributed.bits_to_global``: its word shard,
                      sentinel row last)
      loc  [B_d, K, h] int32 and mask [B_d, K] bool (its ``d`` slice,
                      ``distributed.reads_to_global``)

    -> counts    [B_d, 32 W_t] int32: its (d, t) block of the counts
       n_matched [B] int32: targets with count >= 10, over every shard
       best      [B] int64: the global first maximum, the lowest target id
                 among tied maxima across shards (``jnp.argmax``'s).

    K2' counts (invalid windows point at the sentinel row); ``n_matched``
    is an all-reduce over ``t``, ``best`` an all-gather of each shard's
    (maximum, first target) over ``t``, and both gather over ``d``."""
    _d, t_size, _di, t_index = mesh_place(mesh)

    def step(bits, loc, mask):
        if loc.dim() != 3 or loc.shape[2] != num_hashes:
            raise ValueError(f"loc must be [B, K, {num_hashes}]")
        sent = bits.shape[0] - 1
        loc = torch.where(mask[..., None], loc, sent).to(torch.int32)
        dev = bits.device
        W_t = bits.shape[1]
        counts, _ = count_mask(
            bits, loc.contiguous(),
            torch.zeros(loc.shape[0], dtype=torch.int32, device=dev),
            torch.zeros(32 * W_t, dtype=torch.int32, device=dev))
        n_matched = (counts >= MIN_COUNT).sum(dim=1, dtype=torch.int64)
        group = mesh.get_group("t")
        host = dist.get_backend(group) == "gloo"
        red = n_matched.cpu() if host else n_matched
        dist.all_reduce(red, group=group)
        tg = global_target_ids(1, W_t, t_size, t_index, dev)
        arg = torch.argmax(counts, dim=1)
        top = torch.stack([counts.gather(1, arg[:, None])[:, 0].long(),
                           tg[arg]])
        tops = all_gather_cat(top[None], mesh, "t")  # [t, 2, B_d]
        vals, ids = tops[:, 0], tops[:, 1]
        peak = vals.max(dim=0).values
        best = torch.where(vals == peak, ids, ids.max() + 1).min(dim=0).values
        return (counts,
                all_gather_cat(red.to(dev).to(torch.int32), mesh, "d"),
                all_gather_cat(best, mesh, "d"))

    return step


def host_locations(hashes: np.ndarray, num_hashes: int,
                   num_sigs: int) -> np.ndarray:
    from ..search.kernel import derive_locations

    return derive_locations(hashes, num_hashes, num_sigs).astype(np.int32)
