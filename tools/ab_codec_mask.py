"""Time the dequantize and staged secure-mask kernels of several checkouts
of this repo on one card, each in a fresh process, in the order given (for
a before/after comparison: parent, change, change, parent).

    python3 tools/ab_codec_mask.py ROOT [ROOT ...]
    python3 tools/ab_codec_mask.py --variants [quantize|secure_mask]

Each ROOT holds a ``src/repro_torch`` (a checkout, or a ``git archive`` of
one unpacked into a directory that ``.gitignore`` lists); its kernels build
into ``ROOT/build``.  For each ROOT it prints one JSON line per reading
with three readings of each of:

* ``dequantize R x C`` at the cohort path's leaf shapes (rows 8192 and
  40,960 by widths 256, 16, 32 and 2), at the top-k payload's (1024 x
  57,959), a process worker's (64 x 57,959) and full width (1024 x
  579,594), with the one-call yardstick ``torch.mul(codes, scale)``;
* ``staged B x K x M``: ``secure_mask_apply`` (B = 1, K = 5) at M 579,594
  and 579,593 and ``secure_mask_apply_nodes`` at B = 1024, K = 5,
  M = 579,594;
* ``keyed``: ``secure_mask_apply_rows_keyed`` on every message of a secure
  round at N = 1024 (B = 5120, K = 5, M = 579,594), whose launch this
  comparison must leave as it was.

Each result is held bitwise against its plain twin first.  The timers are
``chip_smoke.py``'s own: ``event_ms`` is ``time_ms`` (CUDA events around
back-to-back calls over at least 20 ms, the wrapper's host cost included),
``device_ms`` is ``device_times`` (the kernels' own time per call from
``torch.profiler``), ``evicted_ms`` the same with the 50 MB L2 cleared
before each launch by a 256 MiB write (``chip_smoke.check``'s reading: the
L2 then holds the write's dirty lines, whose write-back falls in the
kernel's time) and ``evicted_by_read_ms`` with it cleared by a read of the
same buffer (clean lines), each beside its bound
(``chip_smoke.codec_bound`` or ``staged_bound``).

``--variants`` builds the checked-in sources with one choice changed
(``kernels/build.py`` into ``build/sweep/<variant>/``) and times each
variant in this process at the shapes that decide it: the flat
dequantize's grid and warp step (``kDqWaves``, ``kDqWarpStep``) at 40,960
x 256, 8192 x 16 and 64 x 57,959, and the staged kernel's positions per
step, slots loaded together, grid and block size (``kStagePos``,
``kStageSlots``, ``kStageWaves``, ``kStageThreads``) at B = 1 and
B = 1024, each held bitwise to its twin (one source alone where named).
At 2 and 1 positions a thread step the B = 1 grid at M = 579,594 holds
1.07 and 2.14 waves of resident blocks, against 0.27 at the kept 8.
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
READINGS = 3
DQ_SHAPES = ((40_960, 256), (8192, 256), (40_960, 16), (8192, 16), (40_960, 32), (8192, 32),
             (40_960, 2), (8192, 2), (1024, 57_959), (64, 57_959), (1024, 579_594))
M_MAIN, K_MAIN = 579_594, 5
DQ_VARIANTS = [("kept", [])] + [
    (f"kDqWaves{w}", [("kDqWaves = 4;", f"kDqWaves = {w};")]) for w in (2, 8)] + [
    ("kDqWarpStep256", [("kDqWarpStep = 512;", "kDqWarpStep = 256;")])]
STAGE_VARIANTS = [("kept", []), ("kStageThreads256", [("kStageThreads = 128;",
                                                         "kStageThreads = 256;")])] + [
    (f"kStagePos{p}_kStageSlots{k}", [("kStagePos = 8;", f"kStagePos = {p};"),
                                     ("kStageSlots = 8;", f"kStageSlots = {k};")])
    for p, k in ((4, 8), (4, 5), (2, 8), (1, 8))] + [
    ("kStageWaves8", [("kStageWaves = 2;", "kStageWaves = 8;")])]


def inputs(dev):
    """Seeded inputs of every timed call: {label: (kernel, twin, library,
    bound, wrappers)}; the keyed kernel's tables are a secure round's."""
    import torch
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.core.secure import SecureAggregation
    from repro_torch.core.topology import Graph
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import secure_mask as sm

    gen = torch.Generator(device=dev).manual_seed(27)
    calls = {}
    for r, c in DQ_SHAPES:
        codes = torch.randint(-127, 128, (r, c), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        scale = torch.rand((r, 1), generator=gen, device=dev)
        calls[f"dequantize {r} x {c}"] = (
            lambda codes=codes, scale=scale: q.dequantize(codes, scale),
            lambda codes=codes, scale=scale: q.dequantize_ref(codes, scale),
            lambda codes=codes, scale=scale: torch.mul(codes, scale),
            cs.codec_bound(r, c, False), ["dequantize"])
    for b, m in ((1, M_MAIN), (1, M_MAIN - 1), (1024, M_MAIN)):
        x = torch.randn((b, m), generator=gen, device=dev)
        bits = cs.random_words((b, K_MAIN, m), gen, torch.int32)
        signs = torch.randint(-1, 2, (b, K_MAIN), generator=gen, device=dev).float()
        signs[0] = torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0])  # B = 1: every slot read
        if b == 1:
            kern = (lambda x=x, bits=bits, signs=signs:
                    sm.secure_mask_apply(x[0], bits[0], signs[0]))
            twin = (lambda x=x, bits=bits, signs=signs:
                    sm.secure_mask_apply_rows_ref(x, None, bits, signs)[0])
        else:
            kern = lambda x=x, bits=bits, signs=signs: sm.secure_mask_apply_nodes(x, bits, signs)
            twin = (lambda x=x, bits=bits, signs=signs:
                    sm.secure_mask_apply_rows_ref(x, None, bits, signs))
        calls[f"staged {b} x {K_MAIN} x {m}"] = (kern, twin, None, cs.staged_bound(m, signs),
                                                  ["secure_mask_apply_rows"])
    s = SecureAggregation(Graph.regular_circulant(cs.MAIN_N, cs.MAIN_DEG).adj)
    rows, keys, signs = s.message_tables(prng.fold_in(prng.key(17), 3), 3, dev)
    X = torch.randn((cs.MAIN_N, M_MAIN), generator=gen, device=dev)
    calls["keyed"] = (lambda: sm.secure_mask_apply_rows_keyed(X, rows, keys, signs), None, None,
                      None, ["secure_mask_apply_rows_keyed"])
    return calls


def read(label, kernel, twin, library, bound, wrappers, scratch, readings=READINGS):
    """Hold the kernel against its twin, then time it (and the library)."""
    import torch
    import chip_smoke as cs

    if twin is not None:
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        del got, want
    rec = {"label": label, "bound_ms": None if bound is None else bound[0]}
    rec["event_ms"] = [cs.time_ms(kernel) for _ in range(readings)]
    runs = [cs.device_times(kernel, wrappers) for _ in range(readings)]
    rec["device_ms"] = [d["ms"] for d in runs]
    rec["recorded"] = [f"{d['recorded']}/{d['launched']}" for d in runs]
    if not label.startswith("keyed"):
        runs = [cs.device_times(kernel, wrappers, evict=lambda: scratch.fill_(1))
                for _ in range(readings)]
        rec["evicted_ms"] = [d["ms"] for d in runs]
        runs = [cs.device_times(kernel, wrappers, evict=lambda: scratch.sum())
                for _ in range(readings)]
        rec["evicted_by_read_ms"] = [d["ms"] for d in runs]
    if library is not None:
        rec["library_event_ms"] = [cs.time_ms(library) for _ in range(readings)]
        rec["library_device_ms"] = [cs.device_times(library)["ms"] for _ in range(readings)]
    return rec


def child(root):
    import chip_smoke  # the repo's timers; puts this repo's src on sys.path

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.kernels import quantize as q

    if not Path(q.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise AssertionError(f"imported {q.__file__}, not {root}'s")
    dev = torch.device("cuda")
    scratch = torch.empty(chip_smoke.L2_EVICT_BYTES, dtype=torch.uint8, device=dev)
    for label, call in inputs(dev).items():
        print(json.dumps({"root": str(root), **read(label, *call, scratch)}), flush=True)


def variants(kinds=("quantize", "secure_mask")):
    """The checked-in sources with one choice changed, each built and timed
    in this process (one reading of each timer), held bitwise to the
    twins, with the registers the compiler gave each kernel."""
    import torch
    import repro_torch.kernels.build as kb
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import secure_mask as sm

    dev = torch.device("cuda")
    calls = inputs(dev)
    import chip_smoke as cs

    scratch = torch.empty(cs.L2_EVICT_BYTES, dtype=torch.uint8, device=dev)
    picks = {"quantize": ["dequantize 40960 x 256", "dequantize 8192 x 16",
                          "dequantize 64 x 57959"],
             "secure_mask": [f"staged 1 x {K_MAIN} x {M_MAIN}",
                             f"staged 1024 x {K_MAIN} x {M_MAIN}"]}
    for kind, sweep, entry in (("quantize", DQ_VARIANTS, q._entry),
                               ("secure_mask", STAGE_VARIANTS, sm._entry)):
        if kind not in kinds:
            continue
        src = (HERE.parent / "src/repro_torch/kernels/csrc" / f"{kind}.cu").read_text()
        for name, edits in sweep + sweep[::-1]:
            text = src
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"{kind} {name}: {old!r} not in the source")
                text = text.replace(old, new)
            d = HERE.parent / "build" / "sweep" / f"{kind}_{name}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{kind}.cu").write_text(text)
            kb.CSRC = d
            kb.load_library.cache_clear()
            entry.cache_clear()
            log = kb.build(kind).with_suffix(".log").read_text()
            regs = [line.strip() for line in log.splitlines() if "Used" in line]
            for label in picks[kind]:
                rec = read(label, *calls[label], scratch, readings=1)
                print(json.dumps({"variant": name, **rec, "ptxas": regs}), flush=True)


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
        return variants(argv[1:] or ("quantize", "secure_mask"))
    for root in argv:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                       cwd=HERE.parent, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE.parent / "src"))
    sys.exit(main(sys.argv[1:]))
