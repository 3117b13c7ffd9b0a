"""Time the gossip merge of several checkouts of this repo on one card,
each in a fresh process, in the order given (for a before/after
comparison: parent, change, change, parent).

    python3 tools/ab_gossip_mix.py ROOT [ROOT ...]

Each ROOT holds a ``src/repro_torch`` (a checkout, or a ``git archive`` of
one unpacked into a directory that ``.gitignore`` lists); its kernels build
into ``ROOT/build``.  For each ROOT it prints one JSON line with three
readings of each of:

* ``flat``: ``gossip_mix`` at K 6, M 579,594 (the reference's flat form);
* ``wx``: ``w @ x`` on the same inputs, its one-call PyTorch yardstick;
* ``merge``: ``gossip_mix_rows`` at N 1024, K 6 (a 5-regular circulant
  overlay and each node itself), P 579,594: the engine's merge.

The timers are ``chip_smoke.py``'s own: ``*_event_ms`` is ``time_ms``
(CUDA events around back-to-back calls over at least 20 ms, the wrapper's
host cost included), ``*_device_ms`` is ``device_times`` (the kernels' own
time per call from ``torch.profiler``), each beside the kernel records it
stands on and the launches (``*_recorded``).
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
K, M, N, DEG = 6, 579_594, 1024, 5
READINGS = 3


def child(root):
    import chip_smoke  # the repo's timer; puts this repo's src on sys.path

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.core.topology import SparseTopology
    from repro_torch.kernels import gossip_mix as gm

    if not Path(gm.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise AssertionError(f"imported {gm.__file__}, not {root}'s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.randn((K, M), generator=gen, device=dev)
    w1 = torch.rand((K,), generator=gen, device=dev)
    rows, w = SparseTopology.regular_circulant(N, DEG).to(dev).merge_tables()
    X = torch.randn((N, M), generator=gen, device=dev)
    want = gm.gossip_mix_rows_ref(x1, torch.arange(K, dtype=torch.int32, device=dev)[None],
                                  w1[None])[0]
    err = float((gm.gossip_mix(x1, w1) - want).abs().max())
    err_merge = float((gm.gossip_mix_rows(X, rows, w) - gm.gossip_mix_rows_ref(X, rows, w))
                      .abs().max())
    if not err <= 1e-5 or not err_merge <= 1e-5:
        raise AssertionError(f"kernel disagrees with its twin: {err}, {err_merge}")
    calls = {"flat": (lambda: gm.gossip_mix(x1, w1), ["gossip_mix_rows"]),
             "wx": (lambda: w1 @ x1, None),
             "merge": (lambda: gm.gossip_mix_rows(X, rows, w), ["gossip_mix_rows"])}
    rec = {"root": str(root), "max_abs_err": [err, err_merge]}
    for name, (fn, wrappers) in calls.items():
        rec[f"{name}_event_ms"] = [chip_smoke.time_ms(fn) for _ in range(READINGS)]
        runs = [chip_smoke.device_times(fn, wrappers) for _ in range(READINGS)]
        rec[f"{name}_device_ms"] = [d["ms"] for d in runs]
        rec[f"{name}_recorded"] = [f"{d['recorded']}/{d['launched']}" for d in runs]
    print(json.dumps(rec), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--child":
        return child(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                       cwd=HERE.parent, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main(sys.argv[1:]))
