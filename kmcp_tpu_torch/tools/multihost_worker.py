"""One process of a multi-process sharded search.

    python -m kmcp_tpu_torch.tools.multihost_worker PROC_ID NPROCS ADDRESS \\
        [--device DEVICE] [--backend gloo|nccl]

ADDRESS is a port on 127.0.0.1, ``HOST:PORT`` or ``file://PATH`` (a file no
earlier run left).  Port of tools/multihost_worker.py: each process owns
1/NPROCS of the targets' bit-matrix words (the reference's per-node
sub-database) and the whole read batch; the (1, NPROCS) mesh step counts
with no DB rows crossing processes, then the per-target counts all-gather
and are held against a single-process NumPy oracle.  Phase 2 runs the
two-pass screened step with blocks over ``t`` spanning the processes
(``screen.sharded_screened_tail``) against a NumPy oracle of the same
two-pass semantics.  Each phase prints ``proc I: OK ...``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("proc_id", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("address")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    a = ap.parse_args(argv)

    import torch.distributed as dist

    from ..parallel import distributed as D
    from ..parallel.sharding import host_locations
    from ..search.device_step import target_floor
    from ..search.device_step import host_result
    from ..search.screen import sharded_screened_tail

    address = a.address
    if address.isdigit():
        address = f"127.0.0.1:{address}"
    proc_id, nprocs = a.proc_id, a.nprocs
    D.init_distributed(address, nprocs, proc_id, a.backend, a.device)
    try:
        dev = D.rank_device(a.device)
        rng = np.random.default_rng(0)  # identical on every process
        S, W, B, K, H = 4096, 8, 64, 100, 1
        W_global = W * nprocs
        bits_full = rng.integers(0, 2**32, size=(S, W_global),
                                 dtype=np.uint32)
        hashes = rng.integers(1, 2**63, size=(B, K), dtype=np.uint64)
        mask = rng.random((B, K)) < 0.9
        loc = host_locations(hashes, H, S).reshape(B, K, H)

        mesh = D.make_multihost_mesh()
        check(tuple(mesh.shape) == (1, nprocs), f"mesh {mesh.shape}")

        bits_local = bits_full[:, proc_id * W : (proc_id + 1) * W]
        g_bits = D.bits_to_global(bits_local, dev)
        g_loc, g_mask = D.reads_to_global(mesh, loc, mask, dev)
        step = D.make_multihost_search_step(mesh, num_hashes=H)
        counts, n_matched, best = step(g_bits, g_loc, g_mask)
        counts_all = D.allgather_counts(counts, mesh)

        # single-process oracle over the FULL matrix
        rows = np.where(mask[..., None], bits_full[loc[..., 0]],
                        np.uint32(0))  # [B, K, W_global]
        want = np.unpackbits(rows.view(np.uint8), axis=-1,
                             bitorder="little").reshape(
            B, K, W_global * 32).sum(axis=1, dtype=np.int32)
        check(counts_all.shape == want.shape and np.array_equal(
            counts_all, want), "multihost counts != oracle")
        check(np.array_equal(n_matched.cpu().numpy(),
                             (want >= 10).sum(axis=1)), "n_matched != oracle")
        check(np.array_equal(best.cpu().numpy(), want.argmax(axis=1)),
              "best != oracle")
        print(f"proc {proc_id}: OK counts[{counts_all.shape}] == oracle",
              flush=True)

        # ---- phase 2: the two-pass screened step, blocks over 't'
        nb = 4 * nprocs  # blocks must divide the 't' axis
        t_block = 64  # 2 words per block
        W_b = t_block // 32
        s_block = 512
        s_union = 4096
        B2, K2 = 48, 60
        budget = 512
        rng2 = np.random.default_rng(7)  # identical on every process
        # ~12.5% bit fill (the AND of three uniform words): cmin 14 keeps
        # a few hundred candidates under the budget
        bits2 = (
            rng2.integers(0, 2**32, size=(s_block + 1, nb * W_b),
                          dtype=np.uint32)
            & rng2.integers(0, 2**32, size=(s_block + 1, nb * W_b),
                            dtype=np.uint32)
            & rng2.integers(0, 2**32, size=(s_block + 1, nb * W_b),
                            dtype=np.uint32)
        )
        bits2[s_block, :] = 0  # sentinel row
        Wu = -(-nb // 32)
        u2 = rng2.integers(0, 2**32, size=(s_union + 1, Wu), dtype=np.uint32)
        u2[s_union, :] = 0
        loc2 = rng2.integers(0, s_block, size=(B2, K2)).astype(np.int32)
        locu2 = rng2.integers(0, s_union, size=(B2, K2)).astype(np.int32)
        nk2 = np.full(B2, K2, dtype=np.int32)
        lens2 = np.full(B2, 150, dtype=np.int32)
        cmin2 = np.full(K2 + 1, 14, dtype=np.int32)
        theta2 = np.full((nb, K2 + 1), K2 // 2, dtype=np.int32)  # ~50% on
        thr2 = target_floor(np.ones(nb * t_block, np.int32),
                            np.ones(nb * t_block, bool)).reshape(nb, t_block)

        # this process's blocks, row-stacked (block g = word columns
        # g W_b .. (g+1) W_b of bits2), the sentinel row last
        nb_l = nb // nprocs
        own = range(proc_id * nb_l, (proc_id + 1) * nb_l)
        rows2 = [bits2[:s_block, g * W_b : (g + 1) * W_b] for g in own]
        bits_l = np.concatenate(rows2 + [np.zeros((1, W_b), np.uint32)])

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        meta, _aux = host_result(sharded_screened_tail(
            t(bits_l.view(np.int32)), t(u2.view(np.int32)), t(loc2),
            t(locu2), t(nk2), t(lens2), t(cmin2), t(theta2),
            t(thr2[list(own)]), budget, 30, 256, mesh, B2))
        n2 = int(meta[0])
        check(n2 <= budget, "screened multihost budget overflow")
        T2 = nb * t_block
        got2 = set(zip(
            (meta[1 : 1 + n2].astype(np.int64) * T2
             + meta[1 + budget : 1 + budget + n2]).tolist(),
            _aux[:n2].tolist()))

        # numpy oracle of the two-pass semantics over the full arrays
        ub = np.unpackbits(u2[locu2].view(np.uint8), axis=-1,
                           bitorder="little").reshape(B2, K2, Wu * 32)
        active = ub[:, :, :nb].sum(axis=1) >= theta2[:, K2].T
        want2 = set()
        for b in range(B2):
            for g in range(nb):
                if not active[b, g]:
                    continue
                r = bits2[:, g * W_b : (g + 1) * W_b][loc2[b]]
                cb = np.unpackbits(r.view(np.uint8), axis=-1,
                                   bitorder="little").reshape(
                    K2, t_block).sum(axis=0)
                for tl in range(t_block):
                    c = int(cb[tl])
                    if c >= 14:
                        want2.add((b * T2 + g * t_block + tl, c))
        check(bool(want2), "degenerate oracle: no candidates")
        check(got2 == want2, f"screened multihost != oracle ({len(got2)} vs "
              f"{len(want2)})")
        print(f"proc {proc_id}: OK screened sharded step == oracle "
              f"({len(want2)} candidates)", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
