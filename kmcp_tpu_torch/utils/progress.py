"""Terminal progress bars with throughput + ETA.

The port's copy of kmcp_tpu/utils/progress.py: one bar per stage with a
counter, percentage and ETA.  On a TTY the bar redraws in place; on a pipe
it degrades to a plain progress line every few seconds so logs stay
readable.  Thread-safe: compute's file workers advance the same bar
concurrently.
"""

from __future__ import annotations

import sys
import threading
import time

_BAR_W = 24


def _fmt_dur(sec: float) -> str:
    sec = max(int(sec), 0)
    if sec >= 3600:
        return f"{sec // 3600}h{(sec % 3600) // 60:02d}m"
    return f"{sec // 60}:{sec % 60:02d}"


class ProgressBar:
    """``with ProgressBar(total, "compute", unit="files") as bar: ...
    bar.advance()``.  ``enabled=False`` (e.g. --quiet) makes every
    method a no-op."""

    def __init__(
        self,
        total: int,
        label: str,
        unit: str = "files",
        enabled: bool = True,
        stream=None,
        min_interval: float = 0.0,
    ):
        self.total = max(int(total), 0)
        self.label = label
        self.unit = unit
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled and self.total > 0
        self.n = 0
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._last = 0.0
        self._tty = bool(getattr(self.stream, "isatty", lambda: False)())
        # in-place redraws are cheap; plain lines rate-limit harder
        self._interval = min_interval or (0.1 if self._tty else 3.0)
        self._closed = False

    # ------------------------------------------------------------------

    def advance(self, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.n += n
            now = time.time()
            if now - self._last >= self._interval or self.n >= self.total:
                self._last = now
                self._render(now)

    def _render(self, now: float) -> None:
        el = now - self._t0
        frac = min(self.n / self.total, 1.0)
        rate = self.n / el if el > 0 else 0.0
        eta = (self.total - self.n) / rate if rate > 0 else 0.0
        filled = int(frac * _BAR_W)
        bar = "#" * filled + "-" * (_BAR_W - filled)
        line = (
            f"[{self.label}] {self.n}/{self.total} {self.unit} "
            f"[{bar}] {frac * 100:3.0f}% "
            f"{rate:.1f} {self.unit}/s ETA {_fmt_dur(eta)}"
        )
        if self._tty:
            self.stream.write("\r\x1b[K" + line)
            if self.n >= self.total:
                self.stream.write("\n")
        else:
            self.stream.write(line + "\n")
        self.stream.flush()

    def close(self) -> None:
        if not self.enabled or self._closed:
            return
        self._closed = True
        with self._lock:
            if self.n < self.total or self._tty:
                # final state (plain mode prints the 100% line in
                # advance(); TTY needs the newline if short-circuited)
                if self._tty and self.n >= self.total:
                    return
                self._render(time.time())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
