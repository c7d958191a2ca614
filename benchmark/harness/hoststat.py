"""What the host did around the window, for the log only: the main
thread's CPU time against the wall, its wait on the run queue, its moves
between cores, the machine's steal time, and a fixed piece of pure-Python
work timed before and after.  A run that reads slow on the wall but not
in CPU time lost its time to the hypervisor or to other threads; one that
reads slow in both ran on a slower or shared core.
"""

from __future__ import annotations

import os
import time

CALIBRATION_LOOPS = 2_000_000


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _steal_s() -> float | None:
    """The machine's steal time, all cores summed, in seconds."""
    first = _read("/proc/stat").split("\n", 1)[0].split()
    if len(first) < 9 or first[0] != "cpu":
        return None
    return int(first[8]) / os.sysconf("SC_CLK_TCK")


def _sched() -> dict:
    """The main thread's time on a core and on the run queue (s), its
    time slices and its migrations, where the kernel reports them."""
    out = {}
    fields = _read("/proc/self/schedstat").split()
    if len(fields) == 3:
        out.update(run_s=int(fields[0]) / 1e9, queue_s=int(fields[1]) / 1e9,
                   slices=int(fields[2]))
    for line in _read("/proc/self/sched").splitlines():
        if line.startswith("se.nr_migrations"):
            out["migrations"] = int(line.split(":")[1])
    for line in _read("/proc/self/status").splitlines():
        if line.startswith("nonvoluntary_ctxt_switches"):
            out["preempted"] = int(line.split(":")[1])
    return out


def _core() -> int | None:
    """The core the calling thread last ran on."""
    fields = _read("/proc/thread-self/stat").rsplit(")", 1)[-1].split()
    return int(fields[36]) if len(fields) > 36 else None


def calibrate() -> tuple[float, float]:
    """(wall s, thread CPU s) of a fixed pure-Python loop."""
    w, c = time.perf_counter(), time.thread_time()
    x = 0
    for i in range(CALIBRATION_LOOPS):
        x += i & 7
    return time.perf_counter() - w, time.thread_time() - c


class HostStat:
    """A calibration when made, and readings at the window's start
    (``start``) and end (``stop``)."""

    def __init__(self):
        self.cal0 = calibrate()  # outside the set-up's clock

    def start(self) -> None:
        self.core0 = _core()
        self.sched0, self.steal0 = _sched(), _steal_s()
        self.wall0, self.cpu0 = time.perf_counter(), time.thread_time()

    def stop(self) -> None:
        self.wall = time.perf_counter() - self.wall0
        self.cpu = time.thread_time() - self.cpu0
        self.sched1, self.steal1 = _sched(), _steal_s()
        self.core1 = _core()
        self.cal1 = calibrate()

    def line(self) -> str:
        d = {k: self.sched1[k] - self.sched0[k] for k in self.sched1
             if k in self.sched0}
        steal = (None if self.steal0 is None or self.steal1 is None
                 else self.steal1 - self.steal0)
        return (f"host: main thread CPU {self.cpu:.4f} s of {self.wall:.4f} "
                f"s wall ({100 * self.cpu / self.wall:.2f}%), run queue "
                f"{d.get('queue_s', float('nan')):.4f} s, slices "
                f"{d.get('slices')}, preempted {d.get('preempted')}, "
                f"migrations {d.get('migrations')}, core {self.core0} -> "
                f"{self.core1}, machine steal {steal} s; calibration loop "
                f"wall/CPU {self.cal0[0]:.4f}/{self.cal0[1]:.4f} s before, "
                f"{self.cal1[0]:.4f}/{self.cal1[1]:.4f} s after")
