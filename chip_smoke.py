#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
1. device: the card's name and power limit;
2. build: compile every CUDA kernel from ``src/`` with nvcc for sm_90a
   (into ``build/``), one nvcc per source, all started together, timed;
3. kernels: each kernel against its plain PyTorch twin on the card at the
   main paths' shapes and a few others, with its time, the twin's, a
   one-call PyTorch yardstick's where one exists, and the least time the
   card could take (its bound);
4. main path: ``repro_torch.RoundEngine`` — synchronous D-PSGD with full
   sharing over a 5-regular overlay of 1024 nodes, GN-LeNet at width 32,
   8 rounds — with each kernel's launch count read around that run alone,
   then one more round under ``torch.profiler`` (device time by op);
5. topk path: the same engine with TopK sharing at a 10% budget and int8
   payloads, 8 rounds, launch counts read around that run alone, then one
   profiled round and the share step timed alone;
6. reference: the full-sharing engine on a small input, on the card and on
   the CPU from the same parameters, must agree; for TopK (int8) and
   CHOCO-SGD with the histogram selector, every share step of the card's
   run, replayed on the CPU from the same inputs, must agree.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
MAIN_N, MAIN_DEG, MAIN_P = 1024, 5, 579_594  # GN-LeNet width 32
MAIN_K = int(0.1 * MAIN_P)  # the TopK payload at a 10% budget: 57,959
LIBS = ("gossip_mix", "scatter_gossip", "sparsify", "quantize")


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
    return bound_ms(x_rows * p * item + n * k * 8 + n * p * item, 2 * k * n * p)


def bound_ms(nbytes, ops):
    """(least ms, what bounds it): bytes over the memory rate against fp32
    operations over the peak rate, the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(label, kernel, twin, library, bound, tol=None, library_covers=None):
    """Run the kernel and its twin once on the same inputs and hold every
    output together: bitwise when ``tol`` is None, else
    |k - t| <= tol + tol * |t| everywhere.  Time the kernel, the twin and
    the one-call library yardstick (``library_covers`` says what it
    computes)."""
    import torch

    got, want = kernel(), twin()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    ok, max_abs, scale = True, 0.0, 0.0
    for a, b in zip(got, want):
        if tol is None:
            ok = ok and torch.equal(a, b)
        a, b = a.float(), b.float()
        err = (a - b).abs()
        max_abs = max(max_abs, float(err.max()) if err.numel() else 0.0)
        scale = max(scale, float(b.abs().max()) if b.numel() else 0.0)
        if tol is not None:
            ok = ok and bool((err <= tol + tol * b.abs()).all())
        del a, b, err
    del got, want
    rec = {"max_abs_err": max_abs}
    if tol is not None:
        rec["max_rel_err"] = max_abs / scale  # against the output's scale
    rec.update({
        "ms": time_ms(kernel), "plain_ms": time_ms(twin, iters=3, warmup=1),
        "library_ms": time_ms(library) if library is not None else None,
        "bound_ms": bound[0], "bound_by": bound[1],
    })
    if library_covers:
        rec["library_covers"] = library_covers
    print(f"[kernel] {label}: " + " ".join(f"{k}={v}" for k, v in rec.items())
          + f" tol={'bitwise' if tol is None else tol}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain twin "
                             f"({'bitwise' if tol is None else tol})")
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
    out["main"] = check(
        f"gossip_mix_rows fp32 N={n} K={k} P={p}",
        lambda: gm.gossip_mix_rows(X, rows, w),
        lambda: gm.gossip_mix_rows_ref(X, rows, w),
        lambda: torch.sparse.mm(W, X),
        merge_bound_ms(n, k, p, 4, n), tol=1e-5,
    )
    # the same rows at a 16-byte aligned row stride: 16-byte accesses and a
    # masked 2-column tail
    Xp, Yp = padded(n, p, torch.float32, dev), padded(n, p, torch.float32, dev)
    Xp.copy_(X)
    check(
        f"gossip_mix_rows fp32 N={n} K={k} P={p} padded rows",
        lambda: gm.gossip_mix_rows(Xp, rows, w, out=Yp),
        lambda: gm.gossip_mix_rows_ref(Xp, rows, w),
        None, merge_bound_ms(n, k, p, 4, n), tol=1e-5,
    )
    del X, Xp, Yp, W

    # ragged odd row length in bf16 (16-byte vectors and a masked tail)
    p2 = 1_000_003
    Xb = padded(n, p2, torch.bfloat16, dev)
    Xb.copy_(torch.randn((n, p2), generator=gen, device=dev))
    check(
        f"gossip_mix_rows bf16 N={n} K={k} P={p2}",
        lambda: gm.gossip_mix_rows(Xb, rows, w),
        lambda: gm.gossip_mix_rows_ref(Xb, rows, w),
        None, merge_bound_ms(n, k, p2, 2, n), tol=1e-2,
    )
    del Xb

    # the reference's stacked form: (N, K, M) operands, (N, K) weights
    ns = 256
    nb = torch.randn((ns, k, p), generator=gen, device=dev)
    ws = torch.rand((ns, k), generator=gen, device=dev)
    srows = torch.arange(ns * k, dtype=torch.int32, device=dev).view(ns, k)
    check(
        f"gossip_mix_nodes fp32 N={ns} K={k} M={p}",
        lambda: gm.gossip_mix_nodes(nb, ws),
        lambda: gm.gossip_mix_rows_ref(nb.reshape(ns * k, p), srows, ws),
        lambda: torch.bmm(ws[:, None, :], nb),
        merge_bound_ms(ns, k, p, 4, ns * k), tol=1e-5,
    )
    del nb

    # the flat N=1 form
    x1 = torch.randn((k, p), generator=gen, device=dev)
    w1 = torch.rand((k,), generator=gen, device=dev)
    check(
        f"gossip_mix fp32 K={k} M={p}",
        lambda: gm.gossip_mix(x1, w1),
        lambda: gm.gossip_mix_rows_ref(
            x1, torch.arange(k, dtype=torch.int32, device=dev)[None], w1[None]
        )[0],
        lambda: w1 @ x1,
        merge_bound_ms(1, k, p, 4, k), tol=1e-5,
    )
    torch.cuda.empty_cache()
    return out


def codec_bound(r, c, noisy):
    """quantize: x (and noise) read, int8 codes and the scale written;
    abs, max, divide, round and clamp per element.  dequantize moves the
    same bytes less the noise."""
    return bound_ms(r * c * (4 + 1 + (4 if noisy else 0)) + r * 4, 6 * r * c)


def hist_bound(n, p, e):
    """x read once, the edges read, the counts written; |x| and a binary
    search of ceil(log2(E+1)) compares per element."""
    return bound_ms(n * p * 4 + n * e * 4 + n * (e + 1) * 4,
                    n * p * (1 + math.ceil(math.log2(e + 1))))


def payload_bound(n, p, r, k, s):
    """X read and out written once, the (R, k) idx and val payloads and the
    (N, S) tables read once; a subtract, a multiply and an add per
    operand entry."""
    return bound_ms(2 * n * p * 4 + r * k * 8 + n * s * 8, 3 * n * s * k)


def log_edges(a, nbins=128):
    """The coarse edges that ``topk_threshold_rows`` builds for |a|."""
    import torch
    from repro_torch.kernels import sparsify as sp

    hi = a.abs().amax(1)
    lo = torch.clamp_min(hi * 1e-7, 1e-30)
    span = sp._span(nbins, a.device)[None, :]
    return sp._exp(sp._log(lo)[:, None] * (1.0 - span) + sp._log(hi)[:, None] * span).contiguous()


def phase_compressed_kernels():
    """The kernels of the topk path against their twins, at the main
    path's shapes (N=1024, P=579,594, k=57,959; K=6 with the self slot for
    the int8 wire, K=5 without) and a ragged one."""
    import torch
    from repro_torch.core import sharing as sh
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import scatter_gossip as sg
    from repro_torch.kernels import sparsify as sp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n, p, k = MAIN_N, MAIN_P, MAIN_K
    out = {}

    # histogram: |delta| of a TopK round, its coarse edges and one row of
    # non-monotone edges (a fine edge one ulp below its left neighbour)
    delta = torch.randn((n, p), generator=gen, device=dev) * torch.rand(
        (n, 1), generator=gen, device=dev)
    edges = log_edges(delta)
    edges[7, 40] = torch.nextafter(edges[7, 39], torch.zeros((), device=dev))
    out["abs_histogram_rows"] = check(
        f"abs_histogram_rows N={n} P={p} E=128",
        lambda: sp.abs_histogram_rows(delta, edges),
        lambda: sp.abs_histogram_rows_ref(delta, edges),
        lambda: torch.topk(delta.abs(), k, dim=1),
        hist_bound(n, p, 128), library_covers="torch.topk(|x|, k): the whole selection",
    )
    dr = torch.randn((37, 1001), generator=gen, device=dev)
    er = log_edges(dr)
    check("abs_histogram_rows N=37 P=1001 E=128", lambda: sp.abs_histogram_rows(dr, er),
          lambda: sp.abs_histogram_rows_ref(dr, er), None, hist_bound(37, 1001, 128))
    x1 = delta[0].clone()
    check(f"abs_histogram M={p} E=128", lambda: sp.abs_histogram(x1, edges[0]),
          lambda: sp.abs_histogram_rows_ref(x1[None], edges[:1])[0], None,
          hist_bound(1, p, 128))

    # the selection itself (two histogram launches and the compaction)
    idx = sh._topk_idx(delta.abs(), k, "hist")
    torch.cuda.synchronize()
    sel_ms = time_ms(lambda: sh._topk_idx(delta.abs(), k, "hist"), iters=3, warmup=1)
    topk_ms = time_ms(lambda: torch.topk(delta.abs(), k, dim=1), iters=3, warmup=1)
    print(f"[kernel] hist top-k selection N={n} P={p} k={k}: {sel_ms} ms "
          f"(torch.topk {topk_ms} ms)", flush=True)
    del edges, x1

    # codec on the payload values of the same selection
    X = torch.randn((n, p), generator=gen, device=dev)
    val = X.gather(1, idx.long())
    noise = torch.rand((n, k), generator=gen, device=dev)
    out["quantize"] = check(
        f"quantize N={n} k={k}", lambda: q.quantize(val), lambda: q.quantize_ref(val),
        None, codec_bound(n, k, False))
    check(f"quantize noise N={n} k={k}", lambda: q.quantize(val, noise),
          lambda: q.quantize_ref(val, noise), None, codec_bound(n, k, True))
    codes, scale = q.quantize(val)
    out["dequantize"] = check(
        f"dequantize N={n} k={k}", lambda: q.dequantize(codes, scale),
        lambda: q.dequantize_ref(codes, scale), lambda: torch.mul(codes, scale),
        codec_bound(n, k, False), library_covers="torch.mul(codes, scale): the same function")
    vr = torch.randn((37, 1001), generator=gen, device=dev)
    check("quantize N=37 C=1001", lambda: q.quantize(vr), lambda: q.quantize_ref(vr),
          None, codec_bound(37, 1001, False))
    valq = q.dequantize(codes, scale)
    del noise, codes, scale, delta

    # payload merge: the int8 wire (self slot kept, K=6) and the fp32 wire
    # (exact values, self slot dropped, K=5); two launches bitwise equal
    from repro_torch.core.topology import SparseTopology

    st = SparseTopology.regular_circulant(n, MAIN_DEG).to(dev)
    for label, v, self_slot in (("int8 wire", valq, True), ("fp32 wire", val, False)):
        rows, w = st.merge_tables(include_self=self_slot)
        s_ = rows.shape[1]
        a = sg.payload_mix_rows(X, idx, v, rows, w)
        b = sg.payload_mix_rows(X, idx, v, rows, w)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"payload_mix_rows {label}: two launches differ")
        del a, b
        flat = (torch.arange(n, device=dev)[:, None, None] * p
                + idx.long()[rows.long()]).reshape(-1)
        contrib = ((v[rows.long()] - X.gather(1, idx.long()[rows.long()].reshape(n, -1))
                    .view(n, s_, k)) * w[:, :, None]).reshape(-1)
        Y = X.clone()
        rec = check(
            f"payload_mix_rows {label} N={n} P={p} K={s_} k={k}",
            lambda: sg.payload_mix_rows(X, idx, v, rows, w),
            lambda: sg.payload_mix_rows_ref(X, idx, v, rows, w),
            lambda: Y.view(-1).index_add_(0, flat, contrib),
            payload_bound(n, p, n, k, s_), tol=1e-5,
            library_covers="index_add_ of precomputed contributions: the scatter alone",
        )
        out.setdefault("payload_mix_rows", rec)
        del flat, contrib, Y
    nr, pr, kr = 33, 1003, 100
    Xr = torch.randn((nr, pr), generator=gen, device=dev)
    ir = torch.rand((nr, pr), generator=gen, device=dev).argsort(1)[:, :kr].int().contiguous()
    vr2 = torch.randn((nr, kr), generator=gen, device=dev)
    rr, wr = SparseTopology.regular_circulant(nr, 4).to(dev).merge_tables()
    check(f"payload_mix_rows N={nr} P={pr} K=5 k={kr}",
          lambda: sg.payload_mix_rows(Xr, ir, vr2, rr, wr),
          lambda: sg.payload_mix_rows_ref(Xr, ir, vr2, rr, wr), None,
          payload_bound(nr, pr, nr, kr, 5), tol=1e-5)
    del X, val, valq, idx
    torch.cuda.empty_cache()
    return out


def main_path_engine(n, width, n_train, rounds, chunk, eval_every, device, init_params=None,
                     **sharing):
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.models.cnn import cnn_init
    from repro_torch.optim import make_optimizer
    from repro_torch.quickstart import acc_fn, loss_fn

    ds = make_dataset("cifar10", n_train=n_train, n_test=512)
    parts = sharding_partition(ds.train_y, n, shards_per_node=2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, batch_size=8, seed=0)
    dl = DLConfig(**{**dict(sharing="full"), **sharing}, n_nodes=n, topology="regular",
                  degree=MAIN_DEG, local_steps=2, batch_size=8, rounds=rounds,
                  chunk_rounds=chunk, eval_every=eval_every, network="lan")
    return RoundEngine(dl, lambda g: cnn_init(g, width=width), loss_fn, acc_fn,
                       make_optimizer("sgd", 0.05), batcher,
                       init_params=init_params, device=device)


def phase_main_path():
    import torch

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None)
    torch.cuda.synchronize()
    print(f"[main] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"mix_mode={eng.mix_mode}", flush=True)
    assert eng.n_params == MAIN_P, eng.n_params
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist = eng.run(log=True)
    torch.cuda.synchronize()
    launches = read_launches()
    rounds = eng.dl.rounds
    print(f"[main] launches={launches}", flush=True)
    if launches != {**{k: 0 for k in launches}, "gossip_mix_rows": rounds}:
        raise AssertionError(f"main path launches {launches} in {rounds} rounds")
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


def kernel_wrappers():
    """Each kernel's wrapper, which counts the kernel's launches."""
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import scatter_gossip as sg
    from repro_torch.kernels import sparsify as sp

    return {"abs_histogram_rows": sp.abs_histogram_rows, "quantize": q.quantize,
            "dequantize": q.dequantize, "payload_mix_rows": sg.payload_mix_rows,
            "gossip_mix_rows": gm.gossip_mix_rows}


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def phase_topk_path():
    """TopK sharing at a 10% budget with int8 payloads on the main path's
    configuration: per round two histogram launches, one quantize, one
    dequantize, one payload merge and no gather merge."""
    import torch

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           sharing="topk", budget=0.1, payload_quant=True)
    torch.cuda.synchronize()
    print(f"[topk] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"k={MAIN_K} wire={eng.wire_dtype} share_stage_bytes={eng.share_stage_bytes}",
          flush=True)
    assert eng.n_params == MAIN_P, eng.n_params
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist = eng.run(log=True)
    torch.cuda.synchronize()
    launches = read_launches()
    rounds = eng.dl.rounds
    print(f"[topk] launches={launches}", flush=True)
    want = {"abs_histogram_rows": 2 * rounds, "quantize": rounds, "dequantize": rounds,
            "payload_mix_rows": rounds, "gossip_mix_rows": 0}
    if launches != want:
        raise AssertionError(f"topk path launches {launches}, want {want}")
    want_bytes = rounds * MAIN_DEG * (MAIN_K * 5 + 4)
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    if not all(math.isfinite(h["acc_mean"]) for h in hist):
        raise AssertionError(f"non-finite acc_mean in {hist}")
    if not bool(torch.isfinite(eng.X).all()):
        raise AssertionError("non-finite parameters after the topk path")
    span = hist[-1]["round"] - hist[0]["round"]
    rps = span / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    print(f"[topk] rounds/s after the first chunk (evals included): {rps:.4f}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
          f"bytes_sent={eng.bytes_sent} sim_time_s={eng.sim_time_s} "
          f"acc_mean={[h['acc_mean'] for h in hist]}", flush=True)
    return launches, eng


def time_share_step(eng, reps=3):
    """Device-synchronised wall ms of the strategy's share step alone on
    the engine's state (it advances the strategy state; run it last)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        eng.sharing.round(eng.X, eng._mix_static, eng.share_state, key=None,
                          degree=eng._mean_degree)
        torch.cuda.synchronize()
        times.append((time.time() - t) * 1e3)
    print(f"[topk] share step alone (wall ms, synchronised): {times}", flush=True)


def phase_profile(eng, path):
    """One more round of the engine's path (``path`` names it in the log)
    under torch.profiler: the device's
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
    print(f"[profile] one {path}-path round under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy (union of intervals) {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.4f}; sum of device times {sum_ms:.3f} ms",
          flush=True)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {tot / 1e3:10.3f} ms  x{cnt:<5d} {name[:100]}", flush=True)


class Recorder:
    """A strategy that keeps a CPU copy of each round's share-step inputs
    and outputs (X, state, X', state', bytes)."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def round(self, X, W, state, key=None, degree=1.0, rnd=0):
        cpu = lambda st: {k: v.cpu().clone() for k, v in st.items()}
        before = (X.cpu().clone(), cpu(state))
        X2, state, nbytes = self.inner.round(X, W, state, key=key, degree=degree, rnd=rnd)
        self.log.append((*before, X2.cpu().clone(), cpu(state), nbytes))
        return X2, state, nbytes


def phase_reference():
    """At N=16, width 8, 2 rounds, on the card and on the CPU (plain
    twins, CPU convolutions) from one set of parameters: full sharing must
    agree after the run.  TopK (int8) and CHOCO-SGD, both with the
    histogram selector: every share step of the card's run, replayed on the
    CPU from the same inputs, must agree, and so must the bytes.  (Across
    whole runs the compressed strategies are discontinuous: a fp32
    rounding of local training can move a coordinate across the top-k
    threshold or an int8 code boundary.  Their whole-run difference is
    printed.)"""
    import torch
    from repro_torch.core.engine import make_strategy
    from repro_torch.utils.pytree import tree_map

    for sharing in (dict(sharing="full"),
                    dict(sharing="topk", budget=0.1, payload_quant=True),
                    dict(sharing="choco", budget=0.1)):
        gpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cuda",
                               **sharing)
        init = tree_map(lambda a: a.cpu().clone(), gpu.params)
        cpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cpu",
                               init_params=init, **sharing)
        full = sharing["sharing"] == "full"
        if not full:
            rec = Recorder(dataclasses.replace(gpu.sharing, selector="hist"))
            gpu.sharing = gpu.steps.sharing = rec
            cpu.sharing = cpu.steps.sharing = dataclasses.replace(cpu.sharing, selector="hist")
        gpu.run(log=False)
        cpu.run(log=False)
        diff = float((gpu.X.cpu() - cpu.X).abs().max())
        print(f"[reference] {sharing}: N=16 width 8, 2 rounds: max |X_gpu - X_cpu| = {diff}; "
              f"bytes gpu={gpu.bytes_sent} cpu={cpu.bytes_sent}; "
              f"sim_time_s gpu={gpu.sim_time_s} cpu={cpu.sim_time_s}", flush=True)
        if gpu.bytes_sent != cpu.bytes_sent:
            raise AssertionError("bytes_sent differs between card and CPU")
        if full:
            if not diff <= 1e-4:
                raise AssertionError(f"card and CPU disagree: {diff}")
            continue
        strategy = dataclasses.replace(make_strategy(cpu.dl), selector="hist")
        for r, (X, state, X2, state2, nbytes) in enumerate(rec.log):
            X2c, state2c, nbc = strategy.round(X, cpu._mix_static, state, key=None,
                                               degree=cpu._mean_degree)
            d = max([float((X2 - X2c).abs().max())]
                    + [float((state2[k] - state2c[k]).abs().max()) for k in state2])
            print(f"[reference] {sharing['sharing']} round {r}: share step card vs CPU "
                  f"from the same inputs: max diff {d}", flush=True)
            if not d <= 1e-4 or nbc != nbytes:
                raise AssertionError(f"share step card and CPU disagree: {d}, {nbytes} vs {nbc}")
        if len(rec.log) != 2:
            raise AssertionError(f"{len(rec.log)} share steps recorded, want 2")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.time()
    with ThreadPoolExecutor(len(LIBS)) as pool:  # one nvcc per source, all at once
        libs = dict(zip(LIBS, pool.map(build, LIBS)))
    print(f"[build] {len(LIBS)} libraries built in {time.time() - t:.2f} s", flush=True)
    for name, lib in libs.items():
        print(f"[build] {name} -> {lib.relative_to(ROOT)}", flush=True)
        print(lib.with_suffix(".log").read_text().strip(), flush=True)

    checks = phase_kernels()
    checks.update(phase_compressed_kernels())
    launches, eng = phase_main_path()
    launches = {"gossip_mix_rows": launches["gossip_mix_rows"]}
    phase_profile(eng, "main")
    del eng
    torch.cuda.empty_cache()
    topk_launches, eng = phase_topk_path()
    phase_profile(eng, "topk")
    time_share_step(eng)
    del eng
    torch.cuda.empty_cache()
    phase_reference()

    checks["gossip_mix_rows"] = checks.pop("main")
    launches.update({k: v for k, v in topk_launches.items() if k != "gossip_mix_rows"})
    sources = {
        "gossip_mix_rows": ("gossip_mix.cu", "src/repro/kernels/gossip_mix.py:58"),
        "payload_mix_rows": ("scatter_gossip.cu", "src/repro/kernels/scatter_gossip.py:56"),
        "abs_histogram_rows": ("sparsify.cu", "src/repro/kernels/sparsify.py:117"),
        "quantize": ("quantize.cu", "src/repro/kernels/quantize.py:36"),
        "dequantize": ("quantize.cu", "src/repro/kernels/quantize.py:78"),
    }
    kernels = []
    for kernel, (src, replaces) in sources.items():
        c = checks[kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            **({"library_covers": c["library_covers"]} if "library_covers" in c else {}),
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
