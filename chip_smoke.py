#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
1. device: the card's name and power limit;
2. build: compile every CUDA kernel of the main path from ``src/`` with
   nvcc for sm_90a (into ``build/``), timed;
3. kernels: each kernel against its plain PyTorch twin on the card at the
   main path's shapes and a few others, with its time, the twin's, a
   one-call PyTorch yardstick's where one exists, and the least time the
   card could take (its bound);
4. main path: ``repro_torch.RoundEngine`` — synchronous D-PSGD with full
   sharing over a 5-regular overlay of 1024 nodes, GN-LeNet at width 32,
   8 rounds — with each kernel's launch count read around that run alone,
   then one more round under ``torch.profiler`` (device time by op);
5. reference: the same engine on a small input, on the card and on the
   CPU from the same parameters, must agree.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
MAIN_N, MAIN_DEG, MAIN_P = 1024, 5, 579_594  # GN-LeNet width 32


def time_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds per call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def merge_bound_ms(n, k, p, item, x_rows):
    """Least time for out[n] = sum_k w[n,k] X[rows[n,k]]: X's ``x_rows``
    rows read once, the (n, k) index and weight tables read once, out
    written once, against 2*k*n*p fp32 operations; the larger of the two."""
    nbytes = x_rows * p * item + n * k * 8 + n * p * item
    ops = 2 * k * n * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_merge(label, kernel, twin, library, tol, bound):
    """Run the kernel and its twin once on the same inputs, hold them
    together (|k - t| <= tol + tol * |t| everywhere), time all three."""
    import torch

    got, want = kernel().float(), twin().float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = max_abs / float(want.abs().max())  # against the output's scale
    ok = bool((err <= tol + tol * want.abs()).all())
    del got, want, err
    rec = {
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": time_ms(kernel), "plain_ms": time_ms(twin, iters=3, warmup=1),
        "library_ms": time_ms(library) if library is not None else None,
        "bound_ms": bound[0], "bound_by": bound[1],
    }
    print(f"[kernel] {label}: " + " ".join(f"{k}={v}" for k, v in rec.items())
          + f" tol={tol}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain twin beyond {tol}")
    return rec


def padded(n, p, dtype, device):
    """An (n, p) view whose rows start on 16-byte boundaries."""
    import torch

    per = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.empty((n, -(-p // per) * per), dtype=dtype, device=device)[:, :p]


def circulant_merge_tables(n, degree, device):
    from repro_torch.core.topology import SparseTopology

    return SparseTopology.regular_circulant(n, degree).to(device).merge_tables()


def csr_of(rows, w, n_cols):
    """(N, n_cols) CSR matrix with w[n, k] at column rows[n, k]."""
    import torch

    order = rows.long().argsort(dim=1)
    cols = rows.long().gather(1, order)
    vals = w.gather(1, order)
    n, k = rows.shape
    crow = torch.arange(0, n * k + 1, k, device=rows.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1), (n, n_cols))


def phase_kernels():
    import torch
    from repro_torch.kernels import gossip_mix as gm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # main path's shape and layout: the engine's (1+D)-way merge over
    # contiguous rows (P is not a multiple of 4: 8-byte accesses)
    n, p = MAIN_N, MAIN_P
    rows, w = circulant_merge_tables(n, MAIN_DEG, dev)
    k = rows.shape[1]
    X = torch.randn((n, p), generator=gen, device=dev)
    W = csr_of(rows, w, n)
    out["main"] = check_merge(
        f"gossip_mix_rows fp32 N={n} K={k} P={p}",
        lambda: gm.gossip_mix_rows(X, rows, w),
        lambda: gm.gossip_mix_rows_ref(X, rows, w),
        lambda: torch.sparse.mm(W, X),
        1e-5, merge_bound_ms(n, k, p, 4, n),
    )
    # the same rows at a 16-byte aligned row stride: 16-byte accesses and a
    # masked 2-column tail
    Xp, Yp = padded(n, p, torch.float32, dev), padded(n, p, torch.float32, dev)
    Xp.copy_(X)
    check_merge(
        f"gossip_mix_rows fp32 N={n} K={k} P={p} padded rows",
        lambda: gm.gossip_mix_rows(Xp, rows, w, out=Yp),
        lambda: gm.gossip_mix_rows_ref(Xp, rows, w),
        None, 1e-5, merge_bound_ms(n, k, p, 4, n),
    )
    del X, Xp, Yp, W

    # ragged odd row length in bf16 (16-byte vectors and a masked tail)
    p2 = 1_000_003
    Xb = padded(n, p2, torch.bfloat16, dev)
    Xb.copy_(torch.randn((n, p2), generator=gen, device=dev))
    check_merge(
        f"gossip_mix_rows bf16 N={n} K={k} P={p2}",
        lambda: gm.gossip_mix_rows(Xb, rows, w),
        lambda: gm.gossip_mix_rows_ref(Xb, rows, w),
        None, 1e-2, merge_bound_ms(n, k, p2, 2, n),
    )
    del Xb

    # the reference's stacked form: (N, K, M) operands, (N, K) weights
    ns = 256
    nb = torch.randn((ns, k, p), generator=gen, device=dev)
    ws = torch.rand((ns, k), generator=gen, device=dev)
    srows = torch.arange(ns * k, dtype=torch.int32, device=dev).view(ns, k)
    check_merge(
        f"gossip_mix_nodes fp32 N={ns} K={k} M={p}",
        lambda: gm.gossip_mix_nodes(nb, ws),
        lambda: gm.gossip_mix_rows_ref(nb.reshape(ns * k, p), srows, ws),
        lambda: torch.bmm(ws[:, None, :], nb),
        1e-5, merge_bound_ms(ns, k, p, 4, ns * k),
    )
    del nb

    # the flat N=1 form
    x1 = torch.randn((k, p), generator=gen, device=dev)
    w1 = torch.rand((k,), generator=gen, device=dev)
    check_merge(
        f"gossip_mix fp32 K={k} M={p}",
        lambda: gm.gossip_mix(x1, w1),
        lambda: gm.gossip_mix_rows_ref(
            x1, torch.arange(k, dtype=torch.int32, device=dev)[None], w1[None]
        )[0],
        lambda: w1 @ x1,
        1e-5, merge_bound_ms(1, k, p, 4, k),
    )
    torch.cuda.empty_cache()
    return out


def main_path_engine(n, width, n_train, rounds, chunk, eval_every, device, init_params=None):
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.models.cnn import cnn_init
    from repro_torch.optim import make_optimizer
    from repro_torch.quickstart import acc_fn, loss_fn

    ds = make_dataset("cifar10", n_train=n_train, n_test=512)
    parts = sharding_partition(ds.train_y, n, shards_per_node=2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, batch_size=8, seed=0)
    dl = DLConfig(n_nodes=n, topology="regular", degree=MAIN_DEG, sharing="full",
                  local_steps=2, batch_size=8, rounds=rounds, chunk_rounds=chunk,
                  eval_every=eval_every, network="lan")
    return RoundEngine(dl, lambda g: cnn_init(g, width=width), loss_fn, acc_fn,
                       make_optimizer("sgd", 0.05), batcher,
                       init_params=init_params, device=device)


def phase_main_path():
    import torch
    from repro_torch.kernels import gossip_mix as gm

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None)
    torch.cuda.synchronize()
    print(f"[main] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"mix_mode={eng.mix_mode}", flush=True)
    assert eng.n_params == MAIN_P, eng.n_params
    torch.cuda.reset_peak_memory_stats()
    gm.gossip_mix_rows.launches = 0
    hist = eng.run(log=True)
    torch.cuda.synchronize()
    launches = {"gossip_mix_rows": gm.gossip_mix_rows.launches}
    rounds = eng.dl.rounds
    print(f"[main] launches={launches}", flush=True)
    if launches["gossip_mix_rows"] != rounds:
        raise AssertionError(f"merge kernel launched {launches} times in {rounds} rounds")
    want_bytes = rounds * MAIN_DEG * MAIN_P * 4
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    if not eng.sim_time_s > 0:
        raise AssertionError(f"sim_time_s {eng.sim_time_s}")
    if not all(math.isfinite(h["acc_mean"]) for h in hist):
        raise AssertionError(f"non-finite acc_mean in {hist}")
    if not bool(torch.isfinite(eng.X).all()):
        raise AssertionError("non-finite parameters after the main path")
    span = hist[-1]["round"] - hist[0]["round"]
    rps = span / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    print(f"[main] rounds/s after the first chunk (evals included): {rps:.4f}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
          f"bytes_sent={eng.bytes_sent} sim_time_s={eng.sim_time_s} "
          f"acc_mean={[h['acc_mean'] for h in hist]}", flush=True)
    return launches, eng


def phase_profile(eng):
    """One more round of the main path under torch.profiler: the device's
    busy time (union of its kernel and copy intervals) against the round's
    wall time, and the device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.scheduler.run_span(eng.dl.rounds, 1)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    bookkeeping = ("Activity Buffer Request", "Buffer Flush")  # the profiler's own
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in bookkeeping]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += 0.0 if cur_e is None else cur_e - cur_s
    by_name = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    sum_ms = sum(tot for tot, _ in by_name.values()) / 1e3
    print(f"[profile] one main-path round under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy (union of intervals) {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.4f}; sum of device times {sum_ms:.3f} ms",
          flush=True)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {tot / 1e3:10.3f} ms  x{cnt:<5d} {name[:100]}", flush=True)


def phase_reference():
    """The same engine at N=16, width 8, 2 rounds on the card and on the
    CPU (plain twin, CPU convolutions) from one set of parameters."""
    import torch
    from repro_torch.utils.pytree import tree_map

    gpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cuda")
    init = tree_map(lambda a: a.cpu().clone(), gpu.params)
    cpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cpu",
                           init_params=init)
    gpu.run(log=False)
    cpu.run(log=False)
    diff = float((gpu.X.cpu() - cpu.X).abs().max())
    print(f"[reference] N=16 width 8, 2 rounds: max |X_gpu - X_cpu| = {diff}; "
          f"sim_time_s gpu={gpu.sim_time_s} cpu={cpu.sim_time_s}", flush=True)
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU disagree: {diff}")
    if gpu.bytes_sent != cpu.bytes_sent:
        raise AssertionError("bytes_sent differs between card and CPU")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.time()
    lib = build("gossip_mix")
    print(f"[build] gossip_mix built in {time.time() - t:.2f} s -> {lib.relative_to(ROOT)}",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    checks = phase_kernels()
    launches, eng = phase_main_path()
    phase_profile(eng)
    del eng
    torch.cuda.empty_cache()
    phase_reference()

    main = checks["main"]
    kernels = [{
        "name": "gossip_mix_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:58",
        "launches": launches["gossip_mix_rows"],
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
