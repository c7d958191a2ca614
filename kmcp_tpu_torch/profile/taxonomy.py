"""NCBI-style taxdump handling: nodes/names/merged/delnodes, LCA, lineage.

The port's copy of kmcp_tpu/profile/taxonomy.py.  Replaces KMCP's use
of shenwei356/bio/taxdump (cmd/taxonomy.go:32-111).  Works with both the real
NCBI taxdump and custom taxdumps produced by ``taxonkit create-taxdump``
(used by demo-profiling).
"""

from __future__ import annotations

import os


class Taxonomy:
    def __init__(self, taxdump_dir: str):
        self.parent: dict[int, int] = {}
        self.rank: dict[int, str] = {}
        self.names: dict[int, str] = {}
        self.merged: dict[int, int] = {}
        self.deleted: set[int] = set()
        self.root = 1

        nodes = os.path.join(taxdump_dir, "nodes.dmp")
        with open(nodes) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 3:
                    continue
                taxid, parent, rank = int(parts[0]), int(parts[1]), parts[2]
                self.parent[taxid] = parent
                self.rank[taxid] = rank

        names = os.path.join(taxdump_dir, "names.dmp")
        if os.path.isfile(names):
            with open(names) as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|")]
                    if len(parts) < 4:
                        continue
                    if parts[3] == "scientific name":
                        self.names[int(parts[0])] = parts[1]

        merged = os.path.join(taxdump_dir, "merged.dmp")
        if os.path.isfile(merged):
            with open(merged) as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|")]
                    if len(parts) >= 2 and parts[0]:
                        self.merged[int(parts[0])] = int(parts[1])

        deln = os.path.join(taxdump_dir, "delnodes.dmp")
        if os.path.isfile(deln):
            with open(deln) as f:
                for line in f:
                    p = line.split("|")[0].strip()
                    if p:
                        self.deleted.add(int(p))

        self._depth: dict[int, int] = {}
        self._lca_cache: dict[tuple[int, int], int] = {}

    # ------------------------------------------------------------------

    def taxid(self, t: int) -> int:
        """Resolve merged taxids (taxdump.TaxId semantics)."""
        return self.merged.get(t, t)

    def depth(self, t: int) -> int:
        d = self._depth.get(t)
        if d is not None:
            return d
        chain = []
        cur = t
        while cur not in self._depth:
            chain.append(cur)
            p = self.parent.get(cur)
            if p is None or p == cur:
                self._depth[cur] = 0
                chain.pop()
                break
            cur = p
        base = self._depth.get(cur, 0)
        for i, node in enumerate(reversed(chain)):
            self._depth[node] = base + i + 1
        return self._depth.get(t, 0)

    def lca(self, a: int, b: int) -> int:
        a, b = self.taxid(a), self.taxid(b)
        if a == b:
            return a
        key = (a, b) if a < b else (b, a)
        v = self._lca_cache.get(key)
        if v is not None:
            return v
        x, y = a, b
        dx, dy = self.depth(x), self.depth(y)
        while dx > dy:
            x = self.parent.get(x, x)
            dx -= 1
        while dy > dx:
            y = self.parent.get(y, y)
            dy -= 1
        while x != y:
            px, py = self.parent.get(x, x), self.parent.get(y, y)
            if px == x and py == y:
                break
            x, y = px, py
        v = x if x == y else self.root
        self._lca_cache[key] = v
        return v

    def lca_many(self, taxids) -> int:
        it = iter(taxids)
        try:
            acc = next(it)
        except StopIteration:
            return self.root
        for t in it:
            acc = self.lca(acc, t)
        return acc

    def at_or_below_rank(self, t: int, rank: str) -> bool:
        """True when t's rank equals ``rank`` or an ancestor has it
        (taxdump.AtOrBelowRank)."""
        cur = self.taxid(t)
        seen = 0
        while cur and seen < 64:
            if self.rank.get(cur, "") == rank:
                return True
            p = self.parent.get(cur)
            if p is None or p == cur:
                return False
            cur = p
            seen += 1
        return False

    def lineage_taxids(self, t: int) -> list[int]:
        """Root-to-node lineage excluding the root node itself."""
        cur = self.taxid(t)
        out = []
        seen = 0
        while cur and seen < 64:
            out.append(cur)
            p = self.parent.get(cur)
            if p is None or p == cur:
                break
            cur = p
            seen += 1
        out.reverse()
        if out and out[0] == self.root:
            out = out[1:]
        return out

    def lineage_names(self, t: int) -> list[str]:
        return [self.names.get(x, "") for x in self.lineage_taxids(t)]

    def name(self, t: int) -> str:
        return self.names.get(self.taxid(t), "")

    def rank_of(self, t: int) -> str:
        return self.rank.get(self.taxid(t), "")


def load_taxid_map(files: list[str]) -> dict[str, int]:
    out: dict[str, int] = {}
    for path in files:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    out[parts[0]] = int(parts[1])
    return out
