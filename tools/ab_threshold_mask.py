"""Time the threshold-mask kernel of several checkouts of this repo on one
card, each in a fresh process, in the order given (for a before/after
comparison: parent, change, change, parent), then print each timer's median
per checkout.

    python3 tools/ab_threshold_mask.py ROOT [ROOT ...]
    python3 tools/ab_threshold_mask.py --variants [PARENT_ROOT]

Each ROOT holds a ``src/repro_torch`` (a checkout, or a ``git archive`` of
one unpacked into a directory that ``.gitignore`` lists); its kernels build
into ``ROOT/build``.  For each ROOT it prints one JSON line per shape with
three readings of each timer:

* ``flat``: one node's P (M = 579,594, the ``[entry]`` shape), at
  ``topk_threshold``'s own threshold for a 10% budget;
* ``x[1:]``: the same x 4 bytes into its storage (M = 579,593: 4-byte
  loads of x);
* ``full``: the whole state flattened (M = 1024 x 579,594);
* ``M=1003``: a ragged tail, a NaN in x, t = 0.5.

Each result is held against ``threshold_mask_ref`` first, the values by
their int32 views.  The timers are ``chip_smoke.py``'s own: ``event_ms``
is ``time_ms`` (CUDA events around back-to-back calls over at least 20 ms,
the wrapper's host cost included), ``device_ms`` is ``device_times`` (the
kernel's own time per call from ``torch.profiler``; L2-hot at the flat
shapes, whose 5.2 MB stay in the 50 MB L2 between calls), ``evicted_ms``
the same with the L2 cleared before each launch by a 256 MiB write (its
dirty lines' write-back falls in the kernel's time) and
``evicted_by_read_ms`` by a read of that buffer (clean lines), each beside
the bound (``chip_smoke.mask_bound``: 9 bytes an element at 3.35 TB/s).
The last lines give, per shape and ROOT, the median of the readings of
every process that ran that ROOT (six a side for parent, change, change,
parent).

``--variants`` builds the checked-in ``sparsify.cu`` with its choices
changed (``kernels/build.py`` into ``build/sweep/<variant>/``) and times
each in this process, one reading of each timer at the flat shape and the
full one, held to the twin: the chunks a thread loads before it stores
(``kMaskVecs``) by the grid (``kMaskWaves``), and the kept choice without
its streaming cache hints (``__ldcs`` on x, ``__stcs`` on the values and
the mask: ``plain``, or on the stores or the loads alone); with a
PARENT_ROOT, that root's source too (first and last).
"""
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
READINGS = 3
M_FLAT, N_MAIN, K_FRAC = 579_594, 1024, 0.1
TIMERS = ("event_ms", "device_ms", "evicted_ms", "evicted_by_read_ms")
PLAIN_LOADS = [(re.escape("return __ldcs(reinterpret_cast<const float4*>(p));"),
                "return *reinterpret_cast<const float4*>(p);")]
PLAIN_STORES = [(re.escape("__stcs(reinterpret_cast<float4*>(p), v);"),
                 "*reinterpret_cast<float4*>(p) = v;"),
                (re.escape("__stcs(reinterpret_cast<unsigned int*>(p), w);"),
                 "*reinterpret_cast<uint32_t*>(p) = w;")]


def _variant(vecs, waves):
    return (f"kMaskVecs{vecs}_kMaskWaves{waves}",
            [(r"kMaskVecs = \d+;", f"kMaskVecs = {vecs};"),
             (r"kMaskWaves = \d+;", f"kMaskWaves = {waves};")])


# (regex, replacement) edits of the source: chunks a thread by grids of
# resident blocks (1024: one block step a block at every shape here), and
# the kept choice without its streaming hints
VARIANTS = [_variant(v, w) for v in (1, 2, 4, 8) for w in (1, 4, 16, 1024)] + [
    ("plain", PLAIN_LOADS + PLAIN_STORES), ("plain_loads", PLAIN_LOADS),
    ("plain_stores", PLAIN_STORES)]


def inputs(dev):
    """Seeded inputs of every timed call: {label: (x, threshold, evict)}:
    ``evict`` where the operands fit in the L2."""
    import torch
    from repro_torch.kernels import sparsify as sp

    gen = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn(M_FLAT, generator=gen, device=dev)
    t = sp.topk_threshold(x, int(K_FRAC * M_FLAT))
    xf = torch.randn(N_MAIN * M_FLAT, generator=gen, device=dev)
    tf = sp.topk_threshold(xf, N_MAIN * int(K_FRAC * M_FLAT))
    xo = torch.randn(1003, generator=gen, device=dev)
    xo[17] = float("nan")
    return {"flat": (x, t, True), "x[1:]": (x[1:], t, True), "full": (xf, tf, False),
            "M=1003": (xo, 0.5, True)}


def read(label, x, t, evict, scratch, readings=READINGS):
    """Hold the kernel against its twin bitwise, then time it."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import sparsify as sp

    (v, m), (wv, wm) = sp.threshold_mask(x, t), sp.threshold_mask_ref(x, t)
    torch.cuda.synchronize()
    if not (torch.equal(v.view(torch.int32), wv.view(torch.int32)) and torch.equal(m, wm)):
        raise AssertionError(f"{label}: kernel disagrees with its plain twin")
    del v, m, wv, wm
    kernel = lambda: sp.threshold_mask(x, t)  # noqa: E731
    wrappers = ["threshold_mask"]
    rec = {"label": label, "M": x.numel(), "bound_ms": cs.mask_bound(x.numel())[0]}
    rec["event_ms"] = [cs.time_ms(kernel) for _ in range(readings)]
    rec["device_ms"] = [cs.device_times(kernel, wrappers)["ms"] for _ in range(readings)]
    if evict:
        rec["evicted_ms"] = [cs.device_times(kernel, wrappers, evict=lambda: scratch.fill_(1))["ms"]
                             for _ in range(readings)]
        rec["evicted_by_read_ms"] = [
            cs.device_times(kernel, wrappers, evict=lambda: scratch.sum())["ms"]
            for _ in range(readings)]
    return rec


def child(root):
    import chip_smoke  # the repo's timers; puts this repo's src on sys.path

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.kernels import sparsify as sp

    if not Path(sp.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise AssertionError(f"imported {sp.__file__}, not {root}'s")
    dev = torch.device("cuda")
    scratch = torch.empty(chip_smoke.L2_EVICT_BYTES, dtype=torch.uint8, device=dev)
    for label, call in inputs(dev).items():
        print(json.dumps({"root": str(root), **read(label, *call, scratch)}), flush=True)


def variants(parent=None):
    """The checked-in source with its choices changed, each built and timed
    in this process (one reading of each timer), held bitwise to the twin,
    with the registers the compiler gave each kernel; the ``parent`` ROOT's
    source (the same C interface) first and last where given."""
    import torch
    import chip_smoke as cs
    import repro_torch.kernels.build as kb
    from repro_torch.kernels import sparsify as sp

    dev = torch.device("cuda")
    calls = inputs(dev)
    scratch = torch.empty(cs.L2_EVICT_BYTES, dtype=torch.uint8, device=dev)
    src = (HERE.parent / "src/repro_torch/kernels/csrc/sparsify.cu").read_text()
    sweep = VARIANTS + VARIANTS[::-1]
    if parent is not None:
        sweep = [("parent", None)] + sweep + [("parent", None)]
    for name, edits in sweep:
        if edits is None:
            text = (Path(parent) / "src/repro_torch/kernels/csrc/sparsify.cu").read_text()
            edits = []
        else:
            text = src
        for old, new in edits:
            text, hits = re.subn(old, new, text)
            if hits != 1:
                raise ValueError(f"{name}: {old!r} matches the source {hits} times")
        d = HERE.parent / "build" / "sweep" / f"sparsify_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "sparsify.cu").write_text(text)
        kb.CSRC = d
        kb.load_library.cache_clear()
        sp._entry.cache_clear()
        log = kb.build("sparsify").with_suffix(".log").read_text()
        regs = [line.strip() for line in log.splitlines()
                if "Used" in line or "threshold_mask" in line]
        for label in ("flat", "full"):
            rec = read(label, *calls[label], scratch, readings=1)
            print(json.dumps({"variant": name, **rec, "ptxas": regs}), flush=True)


def medians(lines):
    """Per (label, root): each timer's median over every reading."""
    by = {}
    for rec in lines:
        slot = by.setdefault((rec["label"], rec["root"]), {})
        for key in TIMERS:
            slot.setdefault(key, []).extend(rec.get(key, []))
    for (label, root), timers in by.items():
        print(json.dumps({"median": label, "root": root,
                          **{k: statistics.median(v) for k, v in timers.items() if v},
                          "readings": {k: len(v) for k, v in timers.items() if v}}), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--child":
        return child(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if argv[0] == "--variants":
        return variants(*argv[1:2])
    lines = []
    for root in argv:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                             cwd=HERE.parent, check=True, timeout=900, capture_output=True,
                             text=True)
        sys.stderr.write(out.stderr)
        for line in out.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                lines.append(json.loads(line))
    medians(lines)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE.parent / "src"))
    sys.exit(main(sys.argv[1:]))
