"""The plain reference: KMCP's search of reads against a chunked Bloom DB,
worked out again from the configuration's genomes in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
hashes the genomes itself (canonical ntHash1, Mohamadi et al. 2016), cuts
them into chunk targets by KMCP's rule, sizes the Bloom rows by the COBS
formula, lays the targets out in blocks as ``index --tpu-native`` does,
and for each query counts, screens, thresholds and formats its TSV rows as
KMCP's ``search`` does (qCov, tCov, jacc, the Theorem-2 query FPR of the
SBT paper, rows by mKmers down, target k-mers up, target position up).

**Layout.**  Targets are sorted stably by k-mer count over the whole DB
and cut into blocks of ``block_targets``; in each block every run of 8 is
sorted by (name, chunk).  Every block has the COBS row count of the DB's
largest target: a DB of more than one block is the program's only with
``block_screen`` (``index --block-screen --uniform-sigs``), and one block
has its own largest.  A target's position is (block, lane), which is also
the order of its rows' last key.

**Union screen** (``block_screen``, on a DB of more than one block, as
the program screens only then).  Each block has a union Bloom of its
targets' k-mers, one hash, bit ``h mod m``: m is index's size under
``--uniform-sigs``, the COBS size at one hash and a false-positive rate
of ``SCREEN_FPR_U`` for a block's summed target k-mers rounded up to a
power of two of at least 64, the largest over the blocks and the same for
every block, and a block's rate is the exact f = 1 - (1 - 1/m)^n, n its
summed target k-mers.  A
(query, block) pair counts only where the query's union hits reach
theta = max(min_kmers, ceil(f q + 3 sqrt(q f (1 - f)))), in float64: q
is the query's k-mer count, and q and the hits are over the windows that
the program counts, every valid window (repeats included) of a query
within ``kmer_dedup_threshold`` and the distinct windows of one past it,
a pair's mates joined as one k-mer set (the port's ``HostDB._screen``,
and ``screen.active_mask`` after the screened tail's in-step dedup).
Otherwise no target of that block counts for the query.

**Storage.**  Bits are packed 32 targets to an int32 word ([words, rows]
a block, the blocks one after another in one flat array) and each union
32 bits to a word, so memory follows the DB's own bytes.  A bit is set by
adding its value to its word once, which for distinct bits is the OR: a
target's rows are flagged and added at its lane in one call, and a
union's new bits are uniqued first (``set_bits``).  The genomes are
hashed a few at a time, twice (sizes, then bits and unions in one pass).
Runs on the card once the program is freed, or on the CPU in the tests.

``control`` breaks one guarantee of the configuration, for the check that
the comparison can fail: ``"forward_strand"`` hashes the reads on their
forward strand only (the DB stays canonical), ``"counts_u8"`` keeps counts
in 8 bits, saturating at 255.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .genomes import chunk_bounds, genome_name

# ntHash1 seeds of A, C, G, T
SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
         0x295549F54BE24456)
M64 = (1 << 64) - 1
SIGN = -(1 << 63)
CONTROLS = ("forward_strand", "counts_u8")
SCREEN_FPR_U = 0.25  # index --block-screen's union false-positive rate
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


def rows_of(h: torch.Tensor, num_sigs) -> torch.Tensor:
    """h (uint64 bits in int64) mod num_sigs (an int, or int64 that
    broadcasts against h), exact for num_sigs < 2^31."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % num_sigs) * (1 << 32) + lo) % num_sigs


def union_bits(n_kmers: int) -> int:
    """index's union screen for ``n_kmers``: the COBS size at one hash and
    ``SCREEN_FPR_U``, rounded up to a power of two of at least 64 bits."""
    bits = signature_size(n_kmers, 1, SCREEN_FPR_U)
    return 1 << max(6, (bits - 1).bit_length())


def union_fpr(num_bits: int, n_kmers: int) -> float:
    """The exact one-hash rate of a union of ``n_kmers``: 1 - (1 - 1/m)^n."""
    return -math.expm1(max(n_kmers, 1) * math.log1p(-1.0 / num_bits))


def bit_value(bit: torch.Tensor) -> torch.Tensor:
    """int32 words with bit ``bit`` (0-31) alone set: 1 << bit, and -2^31
    for bit 31."""
    value = 1 << bit.long()
    return torch.where(bit == 31, value - (1 << 32), value).to(torch.int32)


def set_bits(words: torch.Tensor, keys: torch.Tensor) -> None:
    """Set the bits ``keys`` (int64; bit i is bit i & 31 of word i >> 5)
    of the int32 ``words``: each bit not set yet is added to its word once,
    which for distinct bits is their OR (no partial sum leaves int32)."""
    keys = torch.unique(keys)
    word, bit = keys >> 5, keys & 31
    new = ((words[word].long() >> bit) & 1) == 0
    words.index_add_(0, word[new], bit_value(bit[new]))


@dataclass
class Block:
    """One block: its targets in lane order, where its bits and its union
    start, and the union's rate."""

    genome: np.ndarray  # [n] each lane's genome
    chunk: np.ndarray  # [n] and chunk
    sizes: np.ndarray  # [n] and distinct k-mers
    words: int  # 32 lanes a word
    offset: int  # its first word in ``Reference.bits``
    union_offset: int = 0  # its first word in ``Reference.unions``
    fpr_u: float = 0.0


class Reference:
    """The DB of ``config`` rebuilt from ``codes`` (its genomes, [G, L]
    base codes) on ``device``; ``rows`` gives each query's TSV rows.
    ``num_sigs`` rows a block, ``union_bits`` a union (0: no screen)."""

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
        self.n_chunks, self.genome_bp = C, L
        sizes = self._sizes(codes, bounds).reshape(-1)  # target g C + c

        # the blocks: targets stably by k-mer count, cut every
        # block_targets, each run of 8 by (name, chunk)
        order = sorted(range(G * C), key=lambda t: sizes[t])
        cut = config["block_targets"]
        groups = [order[i:i + cut] for i in range(0, len(order), cut)]
        screen = len(groups) > 1
        if screen and not config.get("block_screen"):
            raise NotImplementedError("the program serves a DB of more "
                                      "than one block only screened: "
                                      "set block_screen")
        self.num_sigs = signature_size(int(sizes.max()), 1, config["fpr"])
        self.union_bits = max(union_bits(int(sizes[g].sum()))
                              for g in groups) if screen else 0
        block_of = np.zeros(G * C, dtype=np.int64)
        lane = np.zeros(G * C, dtype=np.int64)
        self.blocks: list[Block] = []
        words = u_words = 0
        for b, members in enumerate(groups):
            placed = []
            for r0 in range(0, len(members), 8):
                placed.extend(sorted(members[r0:r0 + 8]))
            placed = np.asarray(placed, dtype=np.int64)
            block_of[placed], lane[placed] = b, np.arange(len(placed))
            blk = Block(placed // C, placed % C, sizes[placed],
                        -(-len(placed) // 32), words)
            words += self.num_sigs * blk.words
            if screen:
                blk.union_offset, blk.fpr_u = u_words, union_fpr(
                    self.union_bits, int(sizes[placed].sum()))
                u_words += self.union_bits // 32
            self.blocks.append(blk)
        self.bits = torch.zeros(words, dtype=torch.int32, device=self.device)
        self.unions = torch.zeros(u_words, dtype=torch.int32,
                                  device=self.device)

        # a target's rows are flagged (a scatter) and added into its lane's
        # bit of each row's word: every target is set once, in one call,
        # so the adds are ORs.  A union's bits: base + h mod m (set_bits)
        block_of, lane = block_of.reshape(G, C), lane.reshape(G, C)
        value = np.where(lane % 32 == 31, -(1 << 31), 1 << (lane % 32))
        u_base = torch.tensor([32 * blk.union_offset for blk in self.blocks],
                              device=self.device)[
                                  torch.from_numpy(block_of).to(self.device)]
        for g0, hashes in self._genome_hashes(codes):
            part = slice(g0, g0 + len(hashes))
            for c, (a, e) in enumerate(bounds):
                h = hashes[:, a:e - self.k + 1]
                kept = h != 0
                rows_c = torch.where(kept, rows_of(h, self.num_sigs),
                                     self.num_sigs)
                for b in np.unique(block_of[part, c]).tolist():
                    blk, sel = self.blocks[b], block_of[part, c] == b
                    rows = rows_c
                    if not sel.all():
                        rows = rows_c[torch.from_numpy(np.nonzero(sel)[0]).to(
                            self.device)]
                    flags = torch.zeros((len(rows), self.num_sigs + 1),
                                        dtype=torch.int32, device=self.device)
                    flags.scatter_(1, rows, 1)
                    word, val = (torch.from_numpy(x[part, c][sel]).to(
                        self.device) for x in (lane // 32, value))
                    self.table(blk).index_add_(0, word, flags[:, :-1]
                                               * val.to(torch.int32)[:, None])
                if screen:
                    set_bits(self.unions, (u_base[part, c:c + 1] + (
                        h & (self.union_bits - 1)))[kept])
        self._fpr: dict = {}

    def table(self, blk: Block) -> torch.Tensor:
        """``blk``'s bits, word-major: int32 [words, num_sigs], a view."""
        return self.bits[blk.offset:blk.offset + self.num_sigs
                         * blk.words].view(blk.words, self.num_sigs)

    def _sizes(self, codes: np.ndarray, bounds) -> np.ndarray:
        """[G, C] distinct non-zero hashes of each chunk target."""
        sizes = np.zeros((codes.shape[0], len(bounds)), dtype=np.int64)
        for g0, hashes in self._genome_hashes(codes):
            for c, (a, b) in enumerate(bounds):
                h = hashes[:, a:b - self.k + 1].sort(dim=1).values
                distinct = torch.ones_like(h, dtype=torch.bool)
                distinct[:, 1:] = h[:, 1:] != h[:, :-1]
                sizes[g0:g0 + len(h), c] = (
                    distinct & (h != 0)).sum(1).cpu().numpy()
        return sizes

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

    def _counts(self, h: torch.Tensor, ok: torch.Tensor) -> list:
        """Windows (hashes, valid) [Q, K] -> each block's counts [Q, 32 W]
        (int64), zero where the query does not pass the block's screen."""
        n = ok.sum(1).cpu().numpy().astype(np.float64)
        rows = rows_of(h, self.num_sigs)
        out = []
        for blk in self.blocks:
            got = self.table(blk)[:, rows]
            got = torch.where(ok, got, 0)  # [W, Q, K]
            counts = torch.stack([((got >> j) & 1).sum(2) for j in
                                  range(32)], 2)  # [W, Q, 32]
            counts = counts.transpose(0, 1).reshape(len(h), -1)
            if self.union_bits:
                hits, theta = self.screen(blk, h, ok, n)
                counts[torch.from_numpy(hits < theta).to(counts.device)] = 0
            out.append(counts)
        return out

    def screen(self, blk: Block, h: torch.Tensor, ok: torch.Tensor,
               n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(union hits, theta) [Q] of the windows (h, ok) [Q, K] against
        ``blk``'s union screen, ``n`` [Q] float64 the queries' k-mer
        counts: the pair counts where hits >= theta."""
        u = self.unions[blk.union_offset:blk.union_offset
                        + self.union_bits // 32]
        p = h & (self.union_bits - 1)
        hits = ((((u[p >> 5].long() >> (p & 31)) & 1) == 1)
                & ok).sum(1).cpu().numpy()
        f = blk.fpr_u
        theta = np.maximum(self.search["min_kmers"], np.ceil(
            f * n + 3.0 * np.sqrt(n * f * (1.0 - f))))
        return hits, theta

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
        per_q: list[list] = [[] for _ in queries]
        for b, (blk, counts) in enumerate(zip(self.blocks,
                                              self._counts(h, ok))):
            if control == "counts_u8":
                counts = counts.clamp(max=255)
            fl = torch.tensor(floors, device=counts.device)[:, None]
            qi, t = torch.nonzero(counts >= fl, as_tuple=True)
            cand = counts[qi, t]
            for q, tt, c in zip(qi.tolist(), t.tolist(), cand.tolist()):
                size = int(blk.sizes[tt])
                if c / size < opt["min_target_cov"]:
                    continue
                f = self._fpr_of(nks[q], c)
                if f > opt["max_fpr"]:
                    continue
                per_q[q].append((c, size, b, tt, f))
        out = []
        for (qid, _s1, _s2, idx), n, qlen, ms in zip(queries, nks, qlens,
                                                     per_q):
            ms.sort(key=lambda m: (-m[0], m[1], m[2], m[3]))
            lines = []
            for c, size, b, tt, f in ms:
                blk = self.blocks[b]
                lines.append(
                    f"{qid}\t{qlen}\t{n}\t{f:.4e}\t{len(ms)}\t"
                    f"{genome_name(int(blk.genome[tt]))}\t"
                    f"{int(blk.chunk[tt])}\t{self.n_chunks}\t"
                    f"{self.genome_bp}\t{self.k}\t"
                    f"{c}\t{c / n:.4f}\t{c / size:.4f}\t"
                    f"{c / (n + size - c):.4f}\t{idx}")
            out.append(lines)
        return out
