"""Time variants of the payload-merge and SSD chunk kernels on one card, at
the paths' shapes, to show what their shapes and choices are worth.

    python3 tools/sweep_payload_ssd.py

Each variant is the checked-in source (``src/repro_torch/kernels/csrc``)
with a few constants or lines replaced, built by ``kernels/build.py`` into
``build/sweep/<variant>/`` and loaded in this process.  Variants:

* ``payload_mix_rows`` (int8 wire: N 1024, P 579,594, k 57,959, a 5-regular
  circulant overlay and each node itself, rows sorted by index): column
  tile x threads per block.  Each is held bitwise against the plain twin.
* ``ssd_chunk`` (the Mamba2-370M forward's G 32, L 256, H 32, P 64, N 128):
  256 threads, the loops unrolled by 2, 4 or 8 heads per block, each held
  against the twin at 1e-4; then ablations whose results are wrong by
  construction and only timed (``checked`` false): no exp, a single TF32
  product (hi x hi) in place of three, no C·Bᵀ phase, only the y blocks,
  only the state blocks, only the staging and C·Bᵀ phase.

Times are ``chip_smoke.py``'s ``time_ms`` (CUDA events around back-to-back
calls), in two passes (the list, then the list reversed).  One JSON line
per variant and pass.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PAYLOAD = [(f"tile{t}_threads{n}", [("kTile = 2048;", f"kTile = {t};"),
                                    ("kThreads = 128;", f"kThreads = {n};")])
           for t, n in ((2048, 128), (4096, 256), (2048, 256), (4096, 128), (1024, 128),
                        (2048, 64), (1024, 64), (4096, 512), (2048, 512))]
Y_LOOP = "      for (int ks = kh; ks < nks; ks += kSplit) {"
STATE_LOOP = "      for (int ks = kh; ks < jrows / 8; ks += kSplit) {"
UNROLL = [(Y_LOOP, "#pragma unroll 2\n" + Y_LOOP), (STATE_LOOP, "#pragma unroll 2\n" + STATE_LOOP)]
THREADS256 = [("kThreads = 512;", "kThreads = 256;")]
SSD = [
    ("kept", [], True),
    ("unroll2", UNROLL, True),
    ("threads256", THREADS256, True),
    ("threads256_unroll2", THREADS256 + UNROLL, True),
    ("heads4", [("kHeads = 16;", "kHeads = 4;")], True),
    ("heads8", [("kHeads = 16;", "kHeads = 8;")], True),
    ("no_exp", [(f"expf(c{i} - c{j})", f"(c{i} - c{j})")
                for i in ("i0", "i1") for j in ("j0", "j1")], False),
    ("one_tf32_product", [("  mma(d, al, bh0, bh1);\n  mma(d, ah, bl0, bl1);\n", "")], False),
    ("no_cb_phase", [("for (int n0 = 0; n0 < a.N; n0 += kNc) {",
                      "for (int n0 = 0; n0 < 0; n0 += kNc) {")], False),
    ("y_blocks_only", [("  const bool state = it < 0;\n",
                        "  const bool state = it < 0;\n  if (state) return;\n")], False),
    ("state_blocks_only", [("  const bool state = it < 0;\n",
                            "  const bool state = it < 0;\n  if (!state) return;\n")], False),
    ("staging_and_cb_only", [("  for (int u = 0; u < units; ++u) {",
                              "  for (int u = 0; u < 0; ++u) {")], False),
]


def use_variant(kind, name, edits):
    """Write the edited source and point `kernels/build.py` at it."""
    import repro_torch.kernels.build as kb
    from repro_torch.kernels import scatter_gossip as sg
    from repro_torch.kernels import ssd_chunk as ssd

    src = (ROOT / "src/repro_torch/kernels/csrc" / f"{kind}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{kind} {name}: {old!r} not in the source")
        src = src.replace(old, new)
    d = ROOT / "build" / "sweep" / f"{kind}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{kind}.cu").write_text(src)
    kb.CSRC = d
    for fn in (kb.load_library, sg._entry, ssd._lib):
        fn.cache_clear()
    log = kb.build(kind).with_suffix(".log").read_text()
    return [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]


def main():
    import torch
    from chip_smoke import MAIN_DEG, MAIN_K, MAIN_N, MAIN_P, time_ms
    from repro_torch.core.topology import SparseTopology
    from repro_torch.kernels import scatter_gossip as sg
    from repro_torch.kernels import ssd_chunk as ssd

    if not torch.cuda.is_available():
        print("sweep_payload_ssd: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)

    n, p, k = MAIN_N, MAIN_P, MAIN_K
    X = torch.randn((n, p), generator=gen, device=dev)
    idx = torch.rand((n, p), generator=gen, device=dev).argsort(1)[:, :k].int()
    idx, val = sg.sort_payload_rows(idx, torch.randn((n, k), generator=gen, device=dev))
    rows, w = SparseTopology.regular_circulant(n, MAIN_DEG).to(dev).merge_tables()
    want = sg.payload_mix_rows_ref(X, idx, val, rows, w)
    for sweep in (PAYLOAD, PAYLOAD[::-1]):
        for name, edits in sweep:
            ptxas = use_variant("scatter_gossip", name, edits)
            got = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=True)
            ok = bool(torch.equal(got, want))
            ms = time_ms(lambda: sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=True))
            print(json.dumps({"kernel": "payload_mix_rows", "variant": name, "ms": ms,
                              "bitwise": ok, "ptxas": ptxas}), flush=True)
            if not ok:
                raise AssertionError(f"payload_mix_rows {name} disagrees with its twin")
    del X, idx, val, want, got
    torch.cuda.empty_cache()

    G, L, H, P, N = 32, 256, 32, 64, 128
    xdt = torch.randn((G, L, H, P), generator=gen, device=dev) * 0.2
    Bc, Cc = torch.randn((2, G, L, N), generator=gen, device=dev) * 0.4
    cum = -torch.cumsum(torch.rand((G, L, H), generator=gen, device=dev) * 0.5, dim=1)
    want = ssd.ssd_chunk_ref(xdt, Bc, Cc, cum)
    for sweep in (SSD, SSD[::-1]):
        for name, edits, checked in sweep:
            ptxas = use_variant("ssd_chunk", name, edits)
            got = ssd.ssd_chunk(xdt, Bc, Cc, cum)
            err = max(float(((a - b).abs() - 1e-4 * b.abs()).max()) for a, b in zip(got, want))
            ms = time_ms(lambda: ssd.ssd_chunk(xdt, Bc, Cc, cum))
            print(json.dumps({"kernel": "ssd_chunk", "variant": name, "ms": ms,
                              "checked": checked, "max(|d| - 1e-4 |t|)": err,
                              "ptxas": ptxas}), flush=True)
            if checked and err > 1e-4:
                raise AssertionError(f"ssd_chunk {name} disagrees with its twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
