"""One run of one cell of the benchmark of the PyTorch/CUDA port
``repro_torch``, on the machine it is started on:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics
are found by name through ``BENCHMARK.json`` at the checkout's root: the
configuration's ``driver`` names ``portbench/drivers/<driver>.py``, the
traffic ``portbench/traffic/<traffic>.json``, each metric
``portbench/metrics/<name>.py`` and the limits ``portbench/checks/<cell>.json``.

A run builds the cell from the seed and drives it through its warm steps
(set-up), then runs whole chunks until ``--seconds`` have passed and
finishes the chunk in flight (the window).  ``--trace 0`` prints the end-to-end
metrics; ``--trace 1`` runs the same window, then one chunk more under
torch.profiler (the device traced alone), and prints the per-layer
metrics.  Last, with the
program's state freed, the plain reference follows the warm steps from
the same seed and each compared number is printed beside its limit.

The run needs the CUDA cards the cell asks for, and exits with another
code than 0, printing no result, where there are fewer, or where JAX or
the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "portbench"
# every kernel cache at a fixed path inside the checkout
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(bench: dict, workload: str):
    """(cell entry, configuration, traffic mix, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "checks" / f"{workload}.json").read_text())
    return cell, cfg, traffic, limits


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The cell's metric entries: end-to-end with ``--trace 0``, per-layer
    with ``--trace 1``; an entry with ``workloads`` counts where it lists
    the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


class Run:
    """What the metric readers read: the cell's driver object, the
    window's scheduler steps, model FLOPs and seconds, and the traced
    chunk (a ``common.Trace``)."""

    def __init__(self, cell, device):
        self.cell, self.device = cell, device
        self.window_steps = 0
        self.window_s = self.window_flops = 0.0
        self.trace = None


def execute(cfg, traffic, limits, metrics, seed, seconds, trace, device):
    """Set-up, window, the traced chunk (``trace``), the check: returns
    the result line (a dict) and the compared numbers."""
    import torch

    from portbench import check, common

    torch.set_num_threads(4)
    driver = common.load_file(BENCH / "drivers" / f"{cfg['driver']}.py", f"driver_{cfg['driver']}")
    cell = driver.Cell(cfg, traffic, seed, device)
    run = Run(cell, device)
    common.sync(device)
    setup_s = time.perf_counter() - T_START
    common.reset_peak(device)
    evals = getattr(cell, "evals", 0)
    t0 = time.perf_counter()
    while True:  # whole chunks, each ending in a host read
        t = time.perf_counter()
        run.window_steps += cell.chunk()
        run.window_s = time.perf_counter() - t0
        print(f"window: a chunk in {run.window_s - (t - t0):.4f} s, "
              f"{run.window_steps} steps so far", file=sys.stderr)
        if run.window_s >= seconds:
            break
    run.window_flops = cell.flops(run.window_steps, getattr(cell, "evals", 0) - evals)
    peak = common.peak_bytes(device)
    failed = 0 if cell.finite() else run.window_steps
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {}
    if trace:
        run.trace = common.profiled(cell.chunk, device)
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.wall_s
        print(f"trace: {run.trace.steps} steps, wall {run.trace.wall_s!r} s, device busy "
              f"{run.trace.busy_s!r} s", file=sys.stderr)
        values = {}
        for m in metrics:
            reader = common.load_file(BENCH / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
            v = reader.read(run)
            if v is not None:
                values[m["name"]] = v
        line["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    else:
        e2e = {"setup_s": setup_s, "rounds_per_s": run.window_steps / run.window_s,
               "peak_mem_gib": peak / 2 ** 30}
        values = {m["name"]: e2e[m["name"]] for m in metrics}
    units = {m["name"]: m["unit"] for m in metrics}
    attempted = run.window_steps
    program = cell.readings
    cell.free()
    del run, cell
    common.sync(device)
    ref = driver.reference(cfg, traffic, seed, device)
    numbers = check.compare(program, ref, limits)
    result = {"correct": check.passed(numbers) and failed == 0, "attempted": attempted,
              "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": dev, **line}
    return result, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic, limits = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, numbers = execute(cfg, traffic, limits, cell_metrics(bench, args.workload,
                                                                 bool(args.trace)),
                              args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in this process: {found} (JAX or the JAX package)")
    # last in the line: each compared number beside its limit
    result["check"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                           "limit": v["limit"]} for k, v in numbers.items()}
    for name, v in numbers.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
