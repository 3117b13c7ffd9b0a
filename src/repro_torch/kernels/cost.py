"""The work of the hand-written kernels, charged to the dry run's counters.

A dispatch mode sees no op inside a CUDA kernel launched through ctypes,
and on the ``meta`` device a kernel wrapper only checks its inputs and
returns empty results.  So while a :func:`charging` tally is open, each
wrapper charges its kernel's cost function (flops, bytes: each input read
once, each output written once) on ``meta`` and on the card alike, and on
the CPU runs its plain twin with the dispatch modes suspended
(:func:`uncounted`): a dry run and a measured run then read the same work,
the kernel's and not the twin's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

_TALLIES: List["KernelTally"] = []


class KernelTally:
    """Flops, bytes and calls charged by kernel wrappers while it is open."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls: Dict[str, int] = {}


@contextlib.contextmanager
def charging():
    """Open a tally for the wrappers called inside the block."""
    tally = KernelTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def counting() -> bool:
    """Whether a tally is open."""
    return bool(_TALLIES)


def charge(name: str, flops: int, nbytes: int) -> None:
    """Add one call of kernel ``name`` to every open tally."""
    for t in _TALLIES:
        t.flops += flops
        t.bytes += nbytes
        t.calls[name] = t.calls.get(name, 0) + 1


@contextlib.contextmanager
def uncounted():
    """Suspend the dispatch modes: a plain twin's ops, run on the CPU in a
    kernel's place while a tally is open, are not the kernel's work."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield
