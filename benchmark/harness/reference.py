"""The plain reference: KMCP's search of reads against a chunked Bloom DB,
worked out again from the configuration's genomes in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
hashes the genomes itself (canonical ntHash1, Mohamadi et al. 2016), cuts
them into chunk targets by KMCP's rule, sizes the Bloom rows by the COBS
formula, orders the targets as ``index --tpu-native`` lays them out, and
for each query counts, thresholds and formats its TSV rows as KMCP's
``search`` does (qCov, tCov, jacc, the Theorem-2 query FPR of the SBT
paper, rows by mKmers down, target k-mers up, target position up).

Bits are kept as a plain [rows, targets] table of booleans; a query's
count for every target is the sum of its windows' rows.  The genomes are
hashed a few at a time.  Runs on the card once the program is freed, or on
the CPU in the tests.

``control`` breaks one guarantee of the configuration, for the check that
the comparison can fail: ``"forward_strand"`` hashes the reads on their
forward strand only (the DB stays canonical), ``"counts_u8"`` keeps counts
in 8 bits, saturating at 255.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .genomes import chunk_bounds, genome_name

# ntHash1 seeds of A, C, G, T
SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
         0x295549F54BE24456)
M64 = (1 << 64) - 1
SIGN = -(1 << 63)
CONTROLS = ("forward_strand", "counts_u8")
GENOMES_AT_ONCE = 8
CODE = np.full(256, 4, dtype=np.uint8)
CODE[list(b"ACGT")] = np.arange(4, dtype=np.uint8)
CODE[list(b"acgt")] = np.arange(4, dtype=np.uint8)


def _rol(x: int, r: int) -> int:
    r %= 64
    return ((x << r) | (x >> (64 - r))) & M64 if r else x


def _signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def signature_size(n_kmers: int, num_hashes: int, fpr: float) -> int:
    """COBS: ceil(n * -h / ln(1 - fpr^(1/h))) Bloom rows."""
    ratio = float(-num_hashes) / math.log(1.0 - math.pow(fpr,
                                                          1.0 / num_hashes))
    return int(math.ceil(float(max(n_kmers, 1)) * ratio))


@functools.lru_cache(maxsize=1 << 16)
def binomial(n: int, k: int) -> float:
    """C(n, k) in KMCP's float order: multiply, then divide, a step."""
    if k > n - k:
        k = n - k
    if k < 0:
        return 0.0
    res = 1.0
    for i in range(k):
        res = res * float(n - i)
        res = res / float(i + 1)
    return res


def query_fpr(n: int, c: int, fpr: float) -> float:
    """P(>= c of n k-mers are false positives), SBT Theorem 2, as KMCP
    sums it: 1 minus the terms up to c, 0 once it turns negative."""
    r = 1.0
    for i in range(c + 1):
        coeff = binomial(n, i)
        if coeff == math.inf:
            return 0.0
        r -= coeff * math.pow(fpr, float(i)) * math.pow(1.0 - fpr,
                                                        float(n - i))
        if r < 0:
            return 0.0
    return r


class Hasher:
    """Canonical ntHash1 of every k-window of rows of base codes."""

    def __init__(self, k: int, device):
        self.k = k
        comp = (3, 2, 1, 0)
        # fh = XOR_m rol(seed(b_m), k-1-m); rh = XOR_m rol(seed(comp b_m), m)
        self.fwd = torch.tensor(
            [[_signed(_rol(SEEDS[b], k - 1 - m)) for b in range(4)] + [0]
             for m in range(k)], dtype=torch.int64, device=device)
        self.rev = torch.tensor(
            [[_signed(_rol(SEEDS[comp[b]], m)) for b in range(4)] + [0]
             for m in range(k)], dtype=torch.int64, device=device)

    def __call__(self, codes: torch.Tensor, canonical: bool = True):
        """codes [R, len] (0-3, 4 = not ACGT) -> (hashes [R, len-k+1]
        int64 holding uint64 bits, valid windows [R, len-k+1])."""
        k = self.k
        n = codes.shape[1] - k + 1
        fh = torch.zeros((codes.shape[0], n), dtype=torch.int64,
                         device=codes.device)
        rh = torch.zeros_like(fh)
        bad = torch.zeros(fh.shape, dtype=torch.bool, device=codes.device)
        for m in range(k):
            b = codes[:, m:m + n].long()
            fh ^= self.fwd[m][b]
            rh ^= self.rev[m][b]
            bad |= b > 3
        if canonical:  # the smaller as unsigned 64-bit numbers
            h = torch.where((fh ^ SIGN) <= (rh ^ SIGN), fh, rh)
        else:
            h = fh
        return h, ~bad & (h != 0)


def rows_of(h: torch.Tensor, num_sigs: int) -> torch.Tensor:
    """h (uint64 bits in int64) mod num_sigs, exact for num_sigs < 2^31."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % num_sigs) * (1 << 32) + lo) % num_sigs


class Reference:
    """The DB of ``config`` rebuilt from ``codes`` (its genomes, [G, L]
    base codes) on ``device``; ``rows`` gives each query's TSV rows."""

    def __init__(self, config: dict, codes: np.ndarray, device):
        if config["num_hashes"] != 1:
            raise NotImplementedError("the reference derives one hash a "
                                      "k-mer (index -n 1)")
        self.config = config
        self.search = config["search"]
        self.device = torch.device(device)
        self.k = config["k"]
        self.hasher = Hasher(self.k, self.device)
        G, L = codes.shape
        bounds = chunk_bounds(config)
        C = len(bounds)

        # target sizes: distinct non-zero hashes of each chunk
        sizes = np.zeros((G, C), dtype=np.int64)
        for g0, hashes in self._genome_hashes(codes):
            for c, (a, b) in enumerate(bounds):
                h = hashes[:, a:b - self.k + 1].sort(dim=1).values
                distinct = torch.ones_like(h, dtype=torch.bool)
                distinct[:, 1:] = h[:, 1:] != h[:, :-1]
                sizes[g0:g0 + len(h), c] = (
                    distinct & (h != 0)).sum(1).cpu().numpy()

        # target order in the one block (index --tpu-native): stably by
        # k-mer count, each run of 8 by (name, chunk)
        order = sorted(range(G * C), key=lambda i: sizes.flat[i])
        if len(order) > config["block_targets"]:
            raise NotImplementedError("more targets than one block holds")
        placed = []
        for r0 in range(0, len(order), 8):
            placed.extend(sorted(order[r0:r0 + 8]))
        self.T = -(-len(placed) // 32) * 32
        pos = np.zeros(G * C, dtype=np.int64)
        pos[placed] = np.arange(len(placed))
        self.pos = pos.reshape(G, C)
        self.size_of = np.zeros(self.T, dtype=np.int64)
        self.size_of[self.pos.reshape(-1)] = sizes.reshape(-1)
        self.name_of = {int(self.pos[g, c]): (genome_name(g), c)
                        for g in range(G) for c in range(C)}
        self.n_chunks, self.genome_bp = C, L

        # rows: the block sized by its largest target
        self.num_sigs = signature_size(int(sizes.max()), 1, config["fpr"])

        self.bits = torch.zeros((self.num_sigs, self.T), dtype=torch.bool,
                                device=self.device)
        tpos = torch.from_numpy(self.pos).to(self.device)
        for g0, hashes in self._genome_hashes(codes):
            for c, (a, b) in enumerate(bounds):
                h = hashes[:, a:b - self.k + 1]
                t = tpos[g0:g0 + len(h), c:c + 1].expand_as(h)
                set_ = h != 0
                self.bits[rows_of(h[set_], self.num_sigs), t[set_]] = True
        self._fpr: dict = {}

    def _genome_hashes(self, codes: np.ndarray):
        """(first genome, hashes [n, L - k + 1]) of each group of
        ``GENOMES_AT_ONCE`` genomes: ACGT genomes, so every window."""
        for g0 in range(0, codes.shape[0], GENOMES_AT_ONCE):
            part = torch.from_numpy(codes[g0:g0 + GENOMES_AT_ONCE])
            yield g0, self.hasher(part.to(self.device))[0]

    def _fpr_of(self, n: int, c: int) -> float:
        v = self._fpr.get((n, c))
        if v is None:
            v = self._fpr[(n, c)] = query_fpr(n, c, self.config["fpr"])
        return v

    def _counts(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [Q, K] Bloom rows (-1: no window) -> counts [Q, T]."""
        hit = self.bits[rows.clamp(min=0)] & (rows >= 0)[..., None]
        return hit.sum(1)

    def rows(self, queries: list, control: str | None = None,
             block: int = 256) -> list[list[str]]:
        """queries: [(query id, seq1 ASCII bytes, seq2 bytes or None,
        queryIdx)] -> each query's TSV rows, in order; with ``control``,
        the rows with that guarantee broken (``CONTROLS``)."""
        if control not in (None, *CONTROLS):
            raise ValueError(f"unknown control {control!r}")
        out = []
        for q0 in range(0, len(queries), block):
            out.extend(self._rows_block(queries[q0:q0 + block], control))
        return out

    def _hashes(self, seqs: list, canonical: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Each query's windows of one mate: (hashes, valid) [Q, n]; a
        missing mate or padding past a read's end gives no window."""
        width = max([self.k] + [len(s or b"") for s in seqs])
        codes = np.full((len(seqs), width), 4, dtype=np.uint8)
        for i, s in enumerate(seqs):
            if s:
                codes[i, :len(s)] = CODE[np.frombuffer(s, dtype=np.uint8)]
        return self.hasher(torch.from_numpy(codes).to(self.device),
                           canonical)

    def _query_kmers(self, queries: list, canonical: bool):
        """The queries' k-mers as KMCP counts them, (hashes, valid) [Q, n]:
        every valid window of each mate (a pair is one k-mer set), uniqued
        only past the dedup threshold."""
        h, ok = self._hashes([q[1] for q in queries], canonical)
        if any(q[2] is not None for q in queries):
            h2, ok2 = self._hashes([q[2] for q in queries], canonical)
            h, ok = torch.cat([h, h2], 1), torch.cat([ok, ok2], 1)
        over = ok.sum(1) > self.search["kmer_dedup_threshold"]
        if bool(over.any()):
            # hash 0 is never a valid window, so it marks the gaps
            srt = torch.where(ok, h, torch.zeros_like(h)).sort(dim=1).values
            first = srt != 0
            first[:, 1:] &= srt[:, 1:] != srt[:, :-1]
            h = torch.where(over[:, None], srt, h)
            ok = torch.where(over[:, None], first, ok)
        return h, ok

    def _rows_block(self, queries: list, control) -> list[list[str]]:
        opt = self.search
        h, ok = self._query_kmers(queries, control != "forward_strand")
        qlens = [len(s1) + (len(s2) if s2 is not None else 0)
                 for _q, s1, s2, _i in queries]
        rows = torch.where(ok, rows_of(h, self.num_sigs),
                           torch.full_like(h, -1))
        counts = self._counts(rows)
        if control == "counts_u8":
            counts = counts.clamp(max=255)
        nks = ok.sum(1).tolist()
        floors = []
        for (_q, s1, s2, _i), n in zip(queries, nks):
            # count > n * min_query_cov (float64), count >= min_kmers; a
            # query shorter than min_query_len on both mates, or with
            # fewer than min_kmers k-mers, has no rows
            c = math.floor(n * opt["min_query_cov"]) + 1
            while not float(c) > n * opt["min_query_cov"]:
                c += 1
            short = max(len(s1), len(s2 or b"")) < opt["min_query_len"]
            ok_n = n >= opt["min_kmers"] and not short
            floors.append(max(c, opt["min_kmers"]) if ok_n else 1 << 30)
        fl = torch.tensor(floors, device=counts.device)[:, None]
        qi, t = torch.nonzero(counts >= fl, as_tuple=True)
        cand = counts[qi, t]
        qi, t, cand = qi.tolist(), t.tolist(), cand.tolist()
        per_q: list[list] = [[] for _ in queries]
        for q, tt, c in zip(qi, t, cand):
            size = int(self.size_of[tt])
            if c / size < opt["min_target_cov"]:
                continue
            f = self._fpr_of(nks[q], c)
            if f > opt["max_fpr"]:
                continue
            per_q[q].append((c, size, tt, f))
        out = []
        for (qid, _s1, _s2, idx), n, qlen, ms in zip(queries, nks, qlens,
                                                     per_q):
            ms.sort(key=lambda m: (-m[0], m[1], m[2]))
            lines = []
            for c, size, tt, f in ms:
                name, chunk = self.name_of[tt]
                lines.append(
                    f"{qid}\t{qlen}\t{n}\t{f:.4e}\t{len(ms)}\t{name}\t"
                    f"{chunk}\t{self.n_chunks}\t{self.genome_bp}\t{self.k}\t"
                    f"{c}\t{c / n:.4f}\t{c / size:.4f}\t"
                    f"{c / (n + size - c):.4f}\t{idx}")
            out.append(lines)
        return out
