"""Run a function on S ranks of a ``torch.distributed`` group: the port's
counterpart of the JAX package's single-controller ``shard_map``.

The JAX package runs one Python program over all its devices; PyTorch
runs one process per rank.  :func:`run` spawns S ranks with
``torch.multiprocessing`` (the ``spawn`` start method: each rank is a
fresh interpreter), starts their process group through a ``FileStore``
in a fresh temporary directory (so parallel runs cannot collide on a
port), calls ``fn(*args, device=...)`` on every rank and returns rank 0's
result.

The group's backend follows the device: gloo on the CPU; on the card,
nccl when there are at least S cards (rank r on card r), else gloo with
every rank on card 0.  Gloo cannot move CUDA memory, so there the sharded
mixing operands stage each transfer through pinned host buffers and count
the staged bytes (``mixing.NodeShard``).  Nothing runs on the CPU in
place of a card: with no card, a call that names no device or asks for
``cuda`` raises.

A rank that raises fails the whole call with its traceback, and a call
that outlives ``timeout`` fails with the ranks still running; either way
every rank is stopped before :func:`run` raises.

    PYTHONPATH=src python -m repro_torch.quickstart --shard-devices 4 --device cpu
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional

import torch

# the kernel libraries a rank may launch, built once before the ranks
# start so that S ranks do not run S compilers on one source
_LIBS = ("gossip_mix", "scatter_gossip", "sparsify", "quantize", "secure_mask")


def _plan(nprocs: int, device: Optional[str] = None):
    """(backend, device of each rank) for ``nprocs`` ranks on ``device``
    ('cpu' or 'cuda'; None means the card)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return "gloo", ["cpu"] * nprocs
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu|cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    cards = torch.cuda.device_count()
    if nprocs <= cards:
        return "nccl", [f"cuda:{r}" for r in range(nprocs)]
    return "gloo", ["cuda:0"] * nprocs


def _rank_main(rank: int, nprocs: int, store: str, backend: str, device: str,
               timeout_s: float, fn, args, results):
    """One rank: join the group, run ``fn``, report (rank, ok, value)."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)  # S ranks share the host's cores
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=nprocs, timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(*args, device=device)
            # by value: a tensor sent through the queue as it is would be
            # shared by a file descriptor that dies with this process
            results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the launcher, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run(fn: Callable[..., Any], nprocs: int, *args, device: Optional[str] = None,
        timeout: float = 600.0) -> Any:
    """``fn(*args, device=...)`` on each of ``nprocs`` ranks; returns rank
    0's result.  ``device`` None means the card (raising where there is
    none); pass 'cpu' to run the ranks on the CPU.

    ``fn`` and ``args`` are pickled to the ranks, so ``fn`` is a module's
    top-level function.  Each rank runs one torch thread.  A rank
    that raises, or a call still running after ``timeout`` seconds, stops
    every rank and raises ``RuntimeError`` with the traceback (or the
    ranks that did not finish)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    backend, devices = _plan(nprocs, device)
    if devices[0].startswith("cuda"):
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.kernels.build import build

        with ThreadPoolExecutor(len(_LIBS)) as pool:
            list(pool.map(build, _LIBS))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_shard_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, store, backend, devices[r], timeout, fn, args, results))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done, value = set(), None
        while len(done) < nprocs:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(timeout=max(0.0, min(left, 1.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]}) without a result")
                if left <= 0:
                    late = sorted(set(range(nprocs)) - done)
                    raise RuntimeError(f"ranks {late} still running after {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{payload}")
            done.add(rank)
            if rank == 0:
                value = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

