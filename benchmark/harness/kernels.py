"""Kernel time and the kernel's bound, for a roofline share.

A wrapper records a CUDA event before and after each call of a kernel's
entry point in the program, and the bytes the call must move: the Bloom
rows its locations touch read once, every other input and output once.
The bytes come from the call's arguments and are counted on the device
after the call, outside the events and without a wait (a few small
kernels a launch, which the trace shows); both are read once the window
has closed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# One NVIDIA H100 SXM, its data sheet's HBM rate at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct(torch, x, size: int):
    """The number of distinct values of ``x`` in [0, size), negative ones
    left out: a device scalar, by a scatter into a map of ``size`` flags
    (no wait, unlike torch.unique, and cheaper than a sort)."""
    x = x.reshape(-1).long()
    seen = torch.zeros(size + 1, dtype=torch.bool, device=x.device)
    seen[torch.where(x >= 0, x, size)] = True
    return seen[:size].sum()


def count_mask_bytes(torch, bits, loc, cthr, thr, out):
    """K2': the rows its locations touch, whole rows of W words, read
    once; the locations, floors and outputs once."""
    fixed = nbytes(loc, cthr, thr, *out)
    return distinct(torch, loc, bits.shape[0]) * (bits.shape[1] * 4) + fixed


@dataclass
class KernelLog:
    """Each call: (start event, end event, bytes as a device scalar)."""

    calls: list = field(default_factory=list)

    def wrap(self, torch, fn, bytes_of):
        def timed(*args, **kwargs):
            if not args[0].is_cuda:  # a plain version on the CPU
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.calls.append((start, end, bytes_of(torch, *args, out)))
            return out
        return timed

    def roofline_pct(self, torch) -> float | None:
        """100 * summed bound / summed device time, None without calls."""
        if not self.calls:
            return None
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b, _ in self.calls)
        moved = float(sum(int(n) for _, _, n in self.calls))
        return 100.0 * (moved / HBM_BYTES_PER_S) / (ms / 1e3)
