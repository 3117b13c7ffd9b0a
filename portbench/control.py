"""The readings that a cell's limits are set from: for each seed, the
plain reference computed in TF32 in the program's place (the control),
the reference with each fault planted (``--faults``) and the program's
own warm steps as a run makes them (``--program``), every one compared
with the float32 reference by the cell's own comparison, and where the
gaps lie (the widest leaves, the spread over nodes) on standard error.
One process reads every seed, so the program's set-up and the
reference's share their start.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--faults] [--program]

Runs on the card at the cell's own size (on the CPU with ``--device
cpu``); prints one JSON line per reading."""
import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FAULTS = ("half_batch", "no_exchange", "answer")


def node_spread(prog, ref):
    """Quantiles (50, 90, 99, 100%) of the node gaps and the number of
    nodes over 1e-4."""
    from portbench import check

    g = check.node_gaps(prog, ref)
    if g is None:
        return None
    return [float(q) for q in np.quantile(g, [0.5, 0.9, 0.99, 1.0])] + [int((g > 1e-4).sum())]


def worst_leaves(prog: dict, ref: dict, k: int = 3):
    """The ``k`` leaves with the widest gaps: (name, gap, program's norm,
    reference's norm)."""
    names = sorted(ref)
    if sorted(prog) != names:
        return []
    med = float(np.median([ref[n] for n in names]))
    rows = [(n, abs(prog[n] - ref[n]) / max(ref[n], med), prog[n], ref[n]) for n in names]
    return sorted(rows, key=lambda r: -r[1])[:k]


def log_gaps(seed, label, r, base):
    """Where a reading's gaps lie: the widest leaves of each change and the
    spread of each per-node number, on standard error."""
    for name, b in base.items():
        if isinstance(b, dict):
            print(f"seed {seed} {label}: widest leaf gaps of {name} {worst_leaves(r[name], b)}",
                  file=sys.stderr, flush=True)
        elif name.endswith("node") and len(b) > 1:
            print(f"seed {seed} {label}: node gaps of {name} (50/90/99/100%, nodes over 1e-4) "
                  f"{node_spread(r[name], b)}", file=sys.stderr, flush=True)


def readings(cfg, traffic, limits, seed, device, faults=True, program=False):
    """{label: numbers} for the control, (``faults``) each fault and
    (``program``) the program."""
    from portbench import check, common

    driver = common.load_file(ROOT / "portbench" / "drivers" / f"{cfg['driver']}.py",
                              f"driver_{cfg['driver']}")
    out = {}
    if program:
        cell = driver.Cell(cfg, traffic, seed, device)
        prog = cell.readings
        cell.free()
        del cell
    base = driver.reference(cfg, traffic, seed, device)
    tf32 = driver.reference(cfg, traffic, seed, device, tf32=True)
    for label, r in (("program", prog if program else None), ("tf32", tf32)):
        if r is not None:
            out[label] = check.compare(r, base, limits)
            log_gaps(seed, label, r, base)
    for fault in FAULTS if faults else ():
        out[fault] = check.compare(driver.reference(cfg, traffic, seed, device, fault=fault),
                                   base, limits)
    return out


def main(argv=None):
    from portbench.run import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic, limits = load_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for label, numbers in readings(cfg, traffic, limits, seed, args.device, args.faults,
                                       args.program).items():
            vals = {k: (v["value"] if math.isfinite(v["value"]) else str(v["value"]))
                    for k, v in numbers.items()}
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": label,
                              "numbers": vals}), flush=True)


if __name__ == "__main__":
    main()
