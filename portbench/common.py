"""Helpers shared by the harness, its drivers and its metric readers:
device synchronisation and memory, the profiler's device intervals, and
loading a file of the benchmark by its name."""
from __future__ import annotations

import importlib.util
import re
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the profiler's own records on the device's timeline
PROFILER_BOOKKEEPING = ("Activity Buffer Request", "Buffer Flush")


T0 = time.perf_counter()


def log(what: str) -> None:
    """A set-up phase's end, in seconds since this module was imported."""
    print(f"setup: {what} at {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def load_file(path: Path, tag: str):
    """The module in ``path`` (a file named after a cell's driver, a
    reference or a metric, which may hold dots), imported once under
    ``portbench_<tag>``."""
    name = "portbench_" + re.sub(r"\W", "_", tag)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def wall_ms(fn, device, reps=3):
    """Device-synchronised host milliseconds of ``reps`` calls of ``fn``."""
    out = []
    for _ in range(reps):
        sync(device)
        t = time.perf_counter()
        fn()
        sync(device)
        out.append((time.perf_counter() - t) * 1e3)
    return out


def union_us(spans):
    """Microseconds covered by the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


class Trace:
    """What one profiled stretch of steady state left: the device's
    intervals (kernels, copies, sets; not the annotations of host ranges),
    and the stretch's wall time and scheduler steps."""

    def __init__(self, prof, wall_s: float, steps: int):
        from torch.autograd import DeviceType

        self.wall_s, self.steps = wall_s, steps
        self.device = []
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() != DeviceType.CPU and not e.is_user_annotation()
                    and e.name() not in PROFILER_BOOKKEEPING):
                a = e.start_ns() / 1e3
                self.device.append((e.name(), a, a + e.duration_ns() / 1e3))

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device]) / 1e6

    def kernel_ms(self, pattern: str):
        """(summed device ms, launches) of the device operations whose name
        matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [(b - a) for n, a, b in self.device if rx.search(n)]
        return sum(hits) / 1e3, len(hits)

    def top_ops(self, k=10):
        by = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """The ``k`` longest stretches in which the device ran nothing, each
        named by the device operation that ended last before it (the host's
        work that follows that operation is what the device waits on)."""
        gaps, end, last = [], None, None
        for n, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is not None and a > end:
                gaps.append((a - end, last))
            if end is None or b >= end:
                end, last = b, n
        gaps.sort(key=lambda g: -g[0])
        return [[f"after {n}", us / 1e6] for us, n in gaps[:k]]


def profiled(fn, device):
    """``fn()`` (one or more whole chunks; returns the scheduler steps it
    ran) under torch.profiler, tracing the device's activity alone: a
    :class:`Trace`.  The wall time is taken inside the profiled stretch,
    between two device synchronisations, so it leaves out the profiler's
    start and the collection of its trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(device)
        t = time.perf_counter()
        steps = fn()
        sync(device)
        wall = time.perf_counter() - t
    return Trace(prof, wall, steps)
