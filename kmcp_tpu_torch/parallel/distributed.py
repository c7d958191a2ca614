"""Multi-process execution on ``torch.distributed``: one process a rank.

Port of kmcp_tpu/parallel/distributed.py.  The reference scales across
machines by giving every node the same queries and a different database
shard, then merging the TSVs offline (KMCP's ``merge``).  The JAX package
makes that one SPMD program over a global mesh; here every rank is a
process with one device, and the mesh is a ``("d", "t")`` DeviceMesh of
ranks:

- axis ``t``: each rank of a ``d`` row owns its target shard of the bit
  matrix, so DB rows never move;
- axis ``d``: data parallelism over the read batch;
- cross-shard results (total matches, the global best target, the
  candidate segments) travel by collectives: the in-program counterpart of
  the offline merge.

Nothing tells a program of a cluster: the caller gives the coordinator's
address, the world size and the rank (or the environment names the JAX
package reads), and the backend.  ``"nccl"`` keeps collectives on the
cards and needs one card a rank; ``"gloo"`` runs them on the host and can
put several ranks on one card or on the CPU.  The backend is never
switched behind the caller's back.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _store(address: str, world: int, rank: int, timeout: timedelta):
    """A rendezvous store: ``file://PATH`` (a file no earlier run left),
    else ``[tcp://]HOST:PORT`` served by rank 0."""
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, is_master=rank == 0,
                         timeout=timeout)


def _card_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "nccl", device=None,
                     timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the process group; returns (rank, world size).

    Environment fallbacks, as in the JAX package: KMCP_TPU_COORDINATOR,
    KMCP_TPU_NUM_PROCS, KMCP_TPU_PROC_ID.  ``device`` is this rank's
    device (default: the card ``cuda:<rank mod cards>``); ``backend`` is
    "nccl" or "gloo".  nccl with a CPU device raises, and so does nccl with
    two ranks on one card (nccl cannot): put such ranks on gloo.  A
    collective that waits past ``timeout_s`` raises."""
    coordinator_address = coordinator_address or os.environ.get(
        "KMCP_TPU_COORDINATOR")
    if num_processes is None and "KMCP_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KMCP_TPU_NUM_PROCS"])
    if process_id is None and "KMCP_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["KMCP_TPU_PROC_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the number of processes and this process's id")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    device = rank_device(device, process_id)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    timeout = timedelta(seconds=timeout_s)
    store = _store(coordinator_address, num_processes, process_id, timeout)
    if backend == "nccl":
        torch.cuda.set_device(device)
        store.set(f"kmcp/card/{process_id}", _card_id(device))
        cards = [store.get(f"kmcp/card/{r}").decode()
                 for r in range(num_processes)]
        if len(set(cards)) != len(cards):
            raise ValueError(
                "backend 'nccl' cannot run two ranks on one card "
                f"({cards}); run such ranks on 'gloo'")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """``device`` as a torch.device; None names this rank's card,
    ``cuda:<rank mod cards>``, and raises where there is no card."""
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA card: name the ranks' device "
                           "(device='cpu' with backend='gloo')")
    rank = dist.get_rank() if rank is None else rank
    return torch.device("cuda", rank % n)


def mesh_device_type() -> str:
    """The device type of the mesh's collectives: the cards' under nccl,
    the host's under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_multihost_mesh():
    """Global (1, P) mesh with ``t`` spanning the P processes: column j is
    process j (its one device), so a word or block shard belongs to one
    process, every process holds the whole read batch, and the layout is
    deterministic (distributed.py:75-95, with one device a process)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), (1, dist.get_world_size()),
                            mesh_dim_names=("d", "t"))


def bits_to_global(bits_local: np.ndarray, device) -> torch.Tensor:
    """This rank's own [S, W_local] uint32 words -> int32 [S+1, W_local] on
    its device, the all-zero sentinel row appended.  Each rank passes and
    keeps only its shard (distributed.py:98-109)."""
    bits = np.ascontiguousarray(bits_local, dtype=np.uint32)
    ext = np.concatenate([bits, np.zeros((1, bits.shape[1]), np.uint32)])
    return torch.from_numpy(ext.view(np.int32)).to(torch.device(device))


def reads_to_global(mesh, loc: np.ndarray, mask: np.ndarray, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The read batch (the same on every rank) -> this rank's ``d`` slice
    of loc int32 [B_d, K, h] and mask bool [B_d, K] on its device; B must
    divide over d (distributed.py:111-124)."""
    from ..search.device_step import mesh_place

    d_size, _t, d_index, _ti = mesh_place(mesh)
    B = loc.shape[0]
    if B % d_size:
        raise ValueError(f"{B} reads do not divide the 'd' axis ({d_size})")
    rows = slice(d_index * (B // d_size), (d_index + 1) * (B // d_size))
    dev = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(loc[rows], np.int32))
            .to(dev),
            torch.from_numpy(np.ascontiguousarray(mask[rows])).to(dev))


def make_multihost_search_step(mesh, num_hashes: int = 1,
                               min_count: int = 10):
    """The sharded count / threshold step over the global mesh
    (sharding.make_sharded_search_step).  ``min_count`` is dropped, as the
    JAX package drops it (distributed.py:127-131): the step keeps its
    fixed 10 (ROADMAP C)."""
    from .sharding import make_sharded_search_step

    del min_count
    return make_sharded_search_step(mesh, num_hashes=num_hashes)


def allgather_counts(counts: torch.Tensor, mesh) -> np.ndarray:
    """Every rank's (d, t) block of the per-target counts -> the whole
    [B, T] matrix on every rank (distributed.py:134-141)."""
    from ..search.device_step import all_gather_cat

    cols = all_gather_cat(counts.t().contiguous(), mesh, "t").t()
    return all_gather_cat(cols.contiguous(), mesh, "d").cpu().numpy()
