"""Time the histogram and quantize kernels on one card at the top-k path's
shapes: checkout against checkout, then variants of this checkout's
sources.

    python3 tools/sweep_hist_quantize.py [ROOT ...]

Data (from seed 1 on the card): delta (1024, 579,594) = randn x a per-row
rand, as ``chip_smoke.py`` makes it; its coarse log edges and the fine
linear edges inside the coarse bin that the path picks (k = 57,959); the
flat N=1 form on row 0; payload values (1024, 57,959) and noise for
``quantize``.

1. Each ROOT (a checkout, or a ``git archive`` of one unpacked into a
   directory that ``.gitignore`` lists; in the order given, for example
   parent, ., ., parent) runs in a fresh process with its own
   ``repro_torch`` and its own ``build/``, and prints one JSON line: each
   call checked bitwise against its twin, then its event time
   (``chip_smoke.time_ms``: CUDA events around back-to-back calls, the
   wrapper's host cost included) and device time
   (``chip_smoke.device_times``: the kernel's own time from
   torch.profiler), for the coarse and the fine pass, the flat form (also
   with the L2 evicted before each launch) and both quantize forms.
2. Variants of ``src/repro_torch/kernels/csrc/{sparsify,quantize}.cu``:
   a few constants or lines replaced, all built in parallel into
   ``build/sweep/<variant>/`` and loaded in this process in turn.  Each is
   held bitwise against the twin, except the ablations that are wrong by
   construction (``checked`` false), which are only timed.  Two passes
   (the list, then the list reversed); one JSON line per variant and
   pass, with its device times.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

STEP = """      b = start<M>(a, r);
      b -= (a < r.e[b - 1]) ? 1 : 0;
      b += (a >= r.e[b]) ? 1 : 0;
"""
ADD = "    if (mid) atomicAdd(&my[b], 1);"
MATCH = """    const unsigned peers = __match_any_sync(0xffffffffu, mid ? b : -1);
    if (mid && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&my[b], __popc(peers));"""
ENDS = """    c0 += (valid && lo) ? 1 : 0;
    cE += (valid && !lo && hi) ? 1 : 0;
"""
ENDS_ATOMIC = """    if (valid && lo) atomicAdd(&my[0], 1);
    if (valid && !lo && hi) atomicAdd(&my[E], 1);
""".replace("my[E]", "my[r.E]")
SEARCH_ALWAYS = ("    if (__syncthreads_and(step)) mode = lg ? kLogStep : kLinearStep;",
                 "    if (__syncthreads_and(step)) mode = kSearch;")
SINGLE = ("  const bool vec = ((xa", "  const bool vec = false && ((xa")


def const(name, old, new):
    return (f"{name} = {old};", f"{name} = {new};")


# (name, edits, checked); the first is the source as checked in
HIST = [
    ("kept", [], True),
    ("unroll1", [const("kUnroll", 2, 1)], True),
    ("unroll4", [const("kUnroll", 2, 4)], True),
    ("unroll4_free_registers", [const("kUnroll", 2, 4), const("kMinBlocks", "2048 / kThreads", 1)],
     True),
    ("free_registers", [const("kMinBlocks", "2048 / kThreads", 1)], True),
    ("threads128", [const("kThreads", 256, 128)], True),
    ("threads512", [const("kThreads", 256, 512)], True),
    ("waves2", [const("kWaves", 8, 2)], True),
    ("waves4", [const("kWaves", 8, 4)], True),
    ("minvecs256", [const("kMinVecs", 512, 256)], True),
    ("minvecs1024", [const("kMinVecs", 512, 1024)], True),
    ("match_any", [(ADD, MATCH)], True),
    ("end_buckets_by_atomics", [(ENDS, ENDS_ATOMIC)], True),
    ("binary_search", [SEARCH_ALWAYS], True),
    ("float2_loads", [const("kVec", 4, 2)], True),
    ("scalar_loads", [const("kVec", 4, 1)], True),
    ("no_atomics", [(ADD, "    if (mid) c0 += b;")], False),
    ("no_search_bucket0", [(STEP, "      b = 0;\n")], False),
]
QUANT = [
    ("kept", [], True),
    ("vecs4", [const("kQVecs", 8, 4)], True),
    ("vecs2", [const("kQVecs", 8, 2)], True),
    ("threads128", [const("kQThreads", 256, 128)], True),
    ("threads512", [const("kQThreads", 256, 512)], True),
    ("threads1024", [const("kQThreads", 256, 1024)], True),
    ("vecs4_threads128", [const("kQVecs", 8, 4), const("kQThreads", 256, 128)], True),
    ("vecs4_threads512", [const("kQVecs", 8, 4), const("kQThreads", 256, 512)], True),
    ("no_cluster", [const("kMaxCluster", 8, 1)], True),
    ("single_columns", [SINGLE], True),
    ("multiply_not_divide", [("to_code(rintf(x / s))", "to_code(rintf(x * s))"),
                             ("floorf(__fadd_rn(x / s, u))", "floorf(__fadd_rn(x * s, u))")],
     False),
]


def make_data():
    import torch
    from chip_smoke import MAIN_K, MAIN_N, MAIN_P, fine_edges, log_edges

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n, p, k = MAIN_N, MAIN_P, MAIN_K
    delta = torch.randn((n, p), generator=gen, device=dev) * torch.rand(
        (n, 1), generator=gen, device=dev)
    coarse = log_edges(delta)
    fine = fine_edges(delta, k, coarse)
    val = torch.randn((n, k), generator=gen, device=dev) * torch.rand(
        (n, 1), generator=gen, device=dev)
    noise = torch.rand((n, k), generator=gen, device=dev)
    return {"delta": delta, "coarse": coarse, "fine": fine, "x1": delta[0].clone(),
            "e1": coarse[0].clone(), "val": val, "noise": noise}


def calls(d):
    """name -> (the call, its twin, its wrapper, L2-resident)."""
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import sparsify as sp

    return {
        "hist_coarse": (lambda: sp.abs_histogram_rows(d["delta"], d["coarse"]),
                        lambda: sp.abs_histogram_rows_ref(d["delta"], d["coarse"]),
                        "abs_histogram_rows", False),
        "hist_fine": (lambda: sp.abs_histogram_rows(d["delta"], d["fine"]),
                      lambda: sp.abs_histogram_rows_ref(d["delta"], d["fine"]),
                      "abs_histogram_rows", False),
        "hist_flat": (lambda: sp.abs_histogram(d["x1"], d["e1"]),
                      lambda: sp.abs_histogram_rows_ref(d["x1"][None], d["e1"][None])[0],
                      "abs_histogram_rows", True),
        "quantize": (lambda: q.quantize(d["val"]), lambda: q.quantize_ref(d["val"]),
                     "quantize", False),
        "quantize_noise": (lambda: q.quantize(d["val"], d["noise"]),
                           lambda: q.quantize_ref(d["val"], d["noise"]), "quantize", False),
    }


def same(a, b):
    import torch

    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def reading(fn, wrapper, l2_resident, event=True):
    import torch
    from chip_smoke import L2_EVICT_BYTES, device_times, time_ms

    dev = device_times(fn, [wrapper])
    rec = {"device_ms": dev["ms"], "recorded": f"{dev['recorded']}/{dev['launched']}"}
    if event:
        rec["event_ms"] = time_ms(fn)
    if l2_resident:
        scratch = torch.empty(L2_EVICT_BYTES, dtype=torch.uint8, device="cuda")
        rec["device_evicted_ms"] = device_times(fn, [wrapper],
                                                evict=lambda: scratch.fill_(1))["ms"]
    return rec


def child(root):
    import chip_smoke  # noqa: F401  (puts this checkout's src on sys.path first)

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.kernels import sparsify as sp

    if not Path(sp.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise AssertionError(f"imported {sp.__file__}, not {root}'s")
    d = make_data()
    rec = {"root": str(root)}
    for name, (fn, twin, wrapper, l2) in calls(d).items():
        ok = same(fn(), twin())
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"{root} {name}: kernel disagrees with its twin")
        rec[name] = reading(fn, wrapper, l2)
    print(json.dumps(rec), flush=True)
    return 0


def prepare(kind, name, edits):
    """Write the variant's source; returns its directory."""
    src = (CSRC / f"{kind}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{kind} {name}: {old!r} not in the source")
        src = src.replace(old, new)
    d = ROOT / "build" / "sweep" / f"{kind}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{kind}.cu").write_text(src)
    return d


def build_in(kind, d):
    """kernels/build.py's build of ``d/<kind>.cu`` in a process of its own
    (the module reads its source directory from a global)."""
    code = ("import sys; from pathlib import Path; import repro_torch.kernels.build as kb; "
            f"kb.CSRC = Path({str(d)!r}); kb.build({kind!r})")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=900,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def use(kind, d):
    """Point kernels/build.py at the variant's (built) source."""
    import repro_torch.kernels.build as kb
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import sparsify as sp

    kb.CSRC = d
    for fn in (kb.load_library, sp._entry, q._entry):
        fn.cache_clear()
    log = kb.build(kind).with_suffix(".log").read_text()
    return [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]


def sweep():
    import torch

    d = make_data()
    table = calls(d)
    want = {name: twin() for name, (_, twin, _, _) in table.items()}
    plan = [("sparsify", HIST, ("hist_coarse", "hist_fine", "hist_flat")),
            ("quantize", QUANT, ("quantize", "quantize_noise"))]
    dirs = {(kind, name): prepare(kind, name, edits)
            for kind, variants, _ in plan for name, edits, _ in variants}
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(build_in, kind, dd) for (kind, _), dd in dirs.items()]:
            f.result()
    for kind, variants, names in plan:
        for order in (variants, variants[::-1]):
            for name, _, checked in order:
                ptxas = use(kind, dirs[(kind, name)])
                rec = {"kernel": kind, "variant": name, "checked": checked, "ptxas": ptxas}
                for call in names:
                    fn, _, wrapper, l2 = table[call]
                    ok = same(fn(), want[call])
                    torch.cuda.synchronize()
                    if checked and not ok:
                        raise AssertionError(f"{kind} {name} {call} disagrees with its twin")
                    rec[call] = {"bitwise": ok, **reading(fn, wrapper, l2, event=False)}
                print(json.dumps(rec), flush=True)
    return 0


def main(argv):
    if len(argv) >= 2 and argv[0] == "--child":
        return child(argv[1])
    import torch

    if not torch.cuda.is_available():
        print("sweep_hist_quantize: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia-smi": smi}), flush=True)
    for root in argv:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                       cwd=ROOT, check=True, timeout=900)
    return sweep()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
