"""Simulator calibration: measured wall-clock vs ``NetworkModel``.

The engine quotes *simulated* time from the ``NetworkModel``; this module
is the receipt that makes those numbers defensible: it runs real
``backend='processes'`` localhost experiments on the port's workers (on
the card unless ``--device`` names another), measures per-round
wall-clock at the sync barrier (max over workers, warm-up rounds
excluded), and records measured-vs-modeled into
``results/torch_calibration.json`` — the modeled side being
``network.localhost_deployment`` through the same
``NetworkModel.round_time`` formula the engine evaluates.

The residual (``implied_compute_s``) is the part the network model does
not claim to predict — local SGD compute plus serialization/python
overhead.  The **sweep** (``run_sweep``) measures that residual across
(N, K, payload format) points and fits it as

    residual ≈ alpha + beta * bytes_per_round

by least squares: ``alpha`` is the per-round constant overhead (framing,
syscalls, barrier slack — what ``NetworkModel.overhead_s`` consumes via
``network.calibrated_localhost``), ``beta`` the per-byte serialization
cost the loopback link model underestimates.  The fit lands in the
``"fit"`` block of the record.

CLI:  PYTHONPATH=src python -m repro_torch.runtime.calibrate \
          --nodes 16 --workers 4 --rounds 12        # one point
      PYTHONPATH=src python -m repro_torch.runtime.calibrate --sweep
      (``--device cpu`` runs the workers on the CPU)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.network import CALIBRATION_PATH
from repro_torch.utils.io import atomic_write_json

DEFAULT_OUT = CALIBRATION_PATH

#: (n_nodes, workers, sharing, payload_quant) sweep grid — small enough
#: for CI, wide enough to separate the constant from the per-byte term.
DEFAULT_SWEEP: Tuple[Tuple[int, int, str, bool], ...] = (
    (16, 4, "full", False),
    (16, 4, "randomk", False),
    (16, 4, "randomk", True),
    (32, 4, "full", False),
    (16, 8, "full", False),
)


def run_calibration(
    n_nodes: int = 16,
    workers: int = 4,
    rounds: int = 12,
    *,
    degree: int = 5,
    sharing: str = "full",
    budget: float = 0.1,
    payload_quant: bool = False,
    workload: Optional[Dict] = None,
    warmup_rounds: int = 2,
    out_path: Optional[str] = DEFAULT_OUT,
    watchdog_s: float = 120.0,
    log: bool = True,
    device=None,
) -> Dict:
    """Measure one (N, K, sharing) point; ``out_path=None`` skips the
    write (the sweep collects points and writes once)."""
    from repro_torch.core.engine import DLConfig, build_graph
    from repro_torch.core.network import localhost_deployment
    from repro_torch.runtime.runner import ProcessRunner

    dl = DLConfig(
        n_nodes=n_nodes, topology="regular", degree=degree, sharing=sharing,
        budget=budget, payload_quant=payload_quant, rounds=rounds,
        eval_every=max(rounds, 1), backend="processes",
    )
    wl = workload or {
        "dataset": "cifar10", "model": "mlp", "width": 2,
        "n_train": 512, "n_test": 256, "lr": 0.05,
    }
    runner = ProcessRunner(dl, wl, workers=workers, watchdog_s=watchdog_s, device=device)
    t0 = time.time()
    runner.run(rounds=rounds, log=log)
    wall_total = time.time() - t0
    measured = np.asarray(runner.round_wall_s, np.float64)
    steady = (
        measured[warmup_rounds:] if len(measured) > warmup_rounds else measured
    )
    # bytes one node sends one neighbor per round, matching the simulator's
    # accounting (FullSharing: P values in the wire dtype; randomk payload:
    # k (idx, val) pairs)
    if sharing.lower() in ("randomk", "random"):
        k = max(1, int(budget * runner.n_params))
        item = 1 if dl.payload_quant else 4
        bytes_per_edge = k * (4 + item) + (4 if dl.payload_quant else 0)
    else:
        bytes_per_edge = runner.n_params * 4
    graph = build_graph(dl)
    net = localhost_deployment(n_nodes)
    modeled_comm_s = net.round_time(graph, bytes_per_edge, compute_time_s=0.0)
    med = float(np.median(steady))
    record = {
        "config": {
            "n_nodes": n_nodes, "workers": workers, "rounds": rounds,
            "degree": degree, "sharing": sharing, "budget": budget,
            "payload_quant": payload_quant,
            "dl": dataclasses.asdict(dl), "workload": wl,
            "device": runner.device,
        },
        "n_params": int(runner.n_params),
        "bytes_per_edge": float(bytes_per_edge),
        "bytes_per_round": float(bytes_per_edge) * degree * n_nodes,
        "measured_round_s": {
            "min": float(steady.min()),
            "median": med,
            "mean": float(steady.mean()),
            "max": float(steady.max()),
            "warmup_excluded": int(min(warmup_rounds, len(measured))),
        },
        "modeled_round_s": float(modeled_comm_s),
        # what the model does not claim: compute + framing/python overhead
        "implied_compute_s": float(med - modeled_comm_s),
        "ratio_measured_over_modeled": float(med / max(modeled_comm_s, 1e-12)),
        "per_round_wall_s": [float(x) for x in measured],
        "total_wall_s": float(wall_total),
        "wire_bytes_per_node": float(runner.bytes_sent),
        "counters": runner.counters,
    }
    if out_path:
        atomic_write_json(out_path, record)
    if log:
        print(
            f"[calibrate] N={n_nodes} K={workers} {sharing}"
            f"{'/int8' if payload_quant else ''} median round "
            f"{med * 1e3:.1f}ms vs modeled comm "
            f"{modeled_comm_s * 1e3:.3f}ms "
            f"(implied compute {record['implied_compute_s'] * 1e3:.1f}ms)",
            flush=True,
        )
    return record


def fit_overhead(points: Sequence[Dict]) -> Dict:
    """Least-squares ``residual ≈ alpha + beta * bytes_per_round`` over
    the sweep points.  With too few points (or a rank-deficient design,
    e.g. every point the same payload size) the slope is pinned to zero
    and ``alpha`` is the median residual — a constant is always
    identifiable from one point."""
    resid = np.array([p["implied_compute_s"] for p in points], np.float64)
    nbytes = np.array([p["bytes_per_round"] for p in points], np.float64)
    alpha, beta = float(np.median(resid)), 0.0
    if len(points) >= 2 and np.ptp(nbytes) > 0:
        A = np.stack([np.ones_like(nbytes), nbytes], axis=1)
        sol, _, rank, _ = np.linalg.lstsq(A, resid, rcond=None)
        if rank == 2:
            alpha, beta = float(sol[0]), float(sol[1])
    pred = alpha + beta * nbytes
    return {
        "alpha_s": alpha,
        "beta_s_per_byte": beta,
        "n_points": len(points),
        "residual_rms_s": float(np.sqrt(np.mean((resid - pred) ** 2))),
    }


def run_sweep(
    grid: Sequence[Tuple[int, int, str, bool]] = DEFAULT_SWEEP,
    *,
    rounds: int = 12,
    out_path: str = DEFAULT_OUT,
    log: bool = True,
    **kw,
) -> Dict:
    """Measure every (N, K, sharing, quant) grid point, fit the per-round
    constant, and record sweep + fit into ``out_path``.  The top level
    keeps the first point's fields so single-point consumers read the
    same schema as before."""
    points: List[Dict] = []
    for n_nodes, workers, sharing, quant in grid:
        points.append(run_calibration(
            n_nodes, workers, rounds, sharing=sharing, payload_quant=quant,
            out_path=None, log=log, **kw,
        ))
    fit = fit_overhead(points)
    record = dict(points[0])
    record["sweep"] = points
    record["fit"] = fit
    atomic_write_json(out_path, record)
    if log:
        print(
            f"[calibrate] sweep fit over {fit['n_points']} points: "
            f"alpha {fit['alpha_s'] * 1e3:.1f}ms/round, beta "
            f"{fit['beta_s_per_byte'] * 1e9:.3f}ns/byte, residual rms "
            f"{fit['residual_rms_s'] * 1e3:.1f}ms -> {out_path}",
            flush=True,
        )
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--sharing", default="full")
    ap.add_argument("--budget", type=float, default=0.1)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--watchdog", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="the workers' torch device (default: the CUDA card)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the (N, K, payload) grid and fit the "
                         "per-round overhead constant")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast run for CI (8 rounds; with --sweep, "
                         "a 3-point grid)")
    args = ap.parse_args(argv)
    rounds = 8 if args.smoke else args.rounds
    if args.sweep:
        grid = DEFAULT_SWEEP[:3] if args.smoke else DEFAULT_SWEEP
        run_sweep(grid, rounds=rounds, out_path=args.out,
                  watchdog_s=args.watchdog, device=args.device)
    else:
        run_calibration(
            args.nodes, args.workers, rounds, degree=args.degree,
            sharing=args.sharing, budget=args.budget, out_path=args.out,
            watchdog_s=args.watchdog, device=args.device,
        )


if __name__ == "__main__":
    main()
