#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
1. device: the card's name and power limit;
2. build: compile every CUDA kernel from ``src/`` with nvcc for sm_90a
   (into ``build/``), one nvcc per source, all started together, timed;
3. kernels: each kernel against its plain PyTorch twin on the card at the
   main paths' shapes and a few others, with its time (CUDA events around
   back-to-back calls, the wrapper's host cost included), its device time
   per call (torch.profiler), the twin's time, a one-call PyTorch
   yardstick's where one exists, and the least time the card could take
   (its bound); the histogram in both passes of the top-k threshold (the
   coarse log edges and the fine linear edges the path builds from them,
   with each pass's bucket shares); for the flat forms, whose operands fit
   in the 50 MB L2, the device time also with the L2 evicted before each
   launch;
4. main path: ``repro_torch.RoundEngine`` — synchronous D-PSGD with full
   sharing over a 5-regular overlay of 1024 nodes, GN-LeNet at width 32,
   8 rounds — with each kernel's launch count read around that run alone,
   then one more round under ``torch.profiler`` (device time by op);
5. topk path: the same engine with TopK sharing at a 10% budget and int8
   payloads, 8 rounds, launch counts read around that run alone, then one
   profiled round and the share step timed alone;
6. secure kernels: the keyed and staged secure-mask kernels and the
   threshold mask against their twins at the secure path's shapes and
   ragged ones;
7. entry points: ``topk_mask_approx``, ``secure_mask_apply_nodes``,
   ``secure_mask_apply``, ``abs_histogram`` and ``gossip_mix``, each
   kernel's launches read around that run (and around each flat form);
8. secure path: the same engine with secure aggregation under churn
   (participation 0.9) with the seed-recovery pass, 8 rounds, launch counts
   (two keyed mask launches and one gather merge per round) and bytes asserted, then one profiled round and the share step alone;
8b. sampled kernels: the gather merge on a dynamic overlay's round table,
   the payload merge on uniform random-k and on strided rows, the quantize
   noise form on per-node Threefry uniforms and dequantize, over the whole
   (1024, 579,594) state, with the uniform draw and the top-k sort timed;
8c. dynamic, randomk and quant paths: the same engine over the dynamic
   overlay (full sharing, 8 rounds), with random-k sharing at a 10%
   budget (uniform sampler, fp32 payloads) and with quantized sharing
   (stochastic rounding), 4 rounds each, launch counts and bytes asserted, then one
   profiled round and the share step alone, with its random draw and (for
   random-k) its selection sort timed apart and the strided sampler's step;
8d. faults path: full sharing under a FaultPlan (message loss 0.1, latency
   spikes 0.05 x10, NaN corruption 0.05, two crash windows) at
   participation 0.9, 8 rounds: one gather merge per round on the
   loss-reweighted table, the counters conserved and equal to the same
   draws recomputed on the CPU, bytes from the host formula; a profiled
   round with every kernel listed, and the guard's three passes timed;
8e. churn-topk path: the topk path at participation 0.9, with its launch
   counts, host-formula bytes, a profiled round that leaves the down
   nodes' last_shared rows bitwise unchanged, and the share step alone;
8f. local, async and async-pairwise paths: the quickstart configuration
   with stragglers (compute 0.05 s, a tenth of the nodes 10x slower) under
   the neighbourhood-barrier clocks (8 rounds; the parameters equal a sync
   engine's bitwise, the largest clock at most the sync barrier's) and
   event-driven gossip (one local step per event: 16 neighbourhood
   cohorts, one gather merge each; 8 pairwise cohorts at participation
   0.9, no kernel), with the clocks, events and staleness printed;
8g. scheduler kernels: the cohort merge over rows [cids | nbr] of a
   100,000-row population and the int8 cold-row codec at a cohort's
   shapes;
8h. population and million: ``benchmarks/bench_population.py``'s stages
   on the port, N=100,000 (flat selection, fp32 cold rows) and
   N=1,000,000 (segment-minimum selection, int8 cold rows, the spread
   clock), C=8192, the (16 -> 16 -> 2) MLP, 32 steps after a warm-up span,
   launch counts per step, events/s, ``memory_model()`` against the
   card's allocated bytes; then the reference's oracles on the card:
   hier == flat bitwise (N=4096, C=256) and the cohort at C = N == the
   dense path bitwise;
8i. processes: the real-network backend (``repro_torch.runtime``) on the
   card: the gather merge, the payload merge and the int8 codec at a
   worker's block shapes, then ``ProcessRunner`` with K=4 worker processes
   sharing the card, N=256 nodes in blocks of 64, GN-LeNet at width 32,
   5-regular, 6 rounds over localhost TCP: full sharing (one gather merge
   per worker per round) and random-k at 10% with the int8 wire (per
   worker per round one payload merge, one quantize, one dequantize of its
   own payload and one of each received frame), each worker's device and
   its launches past warm-up, the round walls (slowest worker) against
   ``localhost_deployment``'s round time for the same bytes, rounds/s;
   and a [reference] case at N=16: the process run on the card against
   the same run on the CPU and the port's simulator on both, within 1e-4,
   with equal bytes and eval rounds;
9. reference: the full-sharing, fault-injected (sparse and dense W),
   secure (plain, and with spikes, corruption and a crash window), dynamic,
   random-k (alone and under churn), Nesterov momentum and AdamW engines,
   the local and async schedulers (neighbourhood, pairwise, under faults)
   and the cohort path (flat, hier, hier with int8 cold rows) on a small
   input, on the card and on the CPU from the same parameters, must agree,
   fault counters, clocks, events, overflow and fallbacks included; for TopK (int8) and CHOCO-SGD with the
   histogram selector and for stochastic quantized sharing, alone and under
   churn, every share step of the card's run, replayed on the CPU from the
   same inputs and key, must agree;
9b. examples: ``repro_torch.topologies_dynamic``,
   ``repro_torch.sparsification``, ``repro_torch.faults``,
   ``repro_torch.churn`` (also with ``--semantics local`` and ``async``),
   ``repro_torch.fl_vs_dl`` and ``repro_torch.secure_aggregation`` on the
   card at ``--rounds 4``, and ``repro_torch.processes`` (the kill demo,
   and ``--rejoin``) at its defaults;
10. lm-kernels: the sliding-window attention and SSD chunk kernels against
   their twins at the two language-model paths' shapes and a few others,
   with ``scaled_dot_product_attention`` under the same band mask as the
   attention kernel's yardstick, and with ``is_causal=True`` beside it
   where the window covers every key (the backend each took is printed);
11. serve: SmolLM-135M (the published config: 30 layers, bf16, window 4096)
   served through ``repro_torch.serving.ServingEngine.generate`` with the
   sliding-window kernel, 8 requests of 4096-token prompts and 32 greedy new
   tokens: 30 kernel launches per generate, all in the prefill, 0 in decode;
11b. serve-bf16-reference: the same model and weights, 2 prompts of 4096
   tokens, prefill logits of the bf16 kernel route and of bf16 plain torch
   attention against the fp32 kernel route on the card, with bounds;
12. forward: the Mamba2-370M teacher-forced forward and loss (the published
   config: 48 layers, bf16, chunk 256) on 4 x 2048 tokens through
   ``repro_torch.models.api.loss_fn`` with the SSD chunk kernel: 48 launches;
13. lm-reference: both models in fp32 at full width and 2 layers, the card
   against the CPU from the same parameters (SmolLM prefill logits and
   greedy ids, Mamba2 forward logits), and Mamba2's forward against its
   token-by-token decode on the card.

The line before the last is a JSON object with one entry per TPU kernel
(13); the last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core rate
TF32_FLOPS = 495e12        # H100 SXM TF32 dense tensor-core rate
INT32_LANES_PER_SM = 64    # INT32 operations per SM and clock (Hopper white paper)
# integer-ALU instructions per Threefry-2x32 call of the keyed secure-mask
# kernel (csrc/secure_mask.cu): 20 funnel-shift rotates, 20 xors and the
# >> 8 of its two outputs, as `cuobjdump -sass` of the sm_90a build shows
# its cipher loop (20 SHF.L.W, 20 LOP3 xors, 2 SHF.R; PERF.md records them).
# Its 26 adds are left out: Hopper issues an add as IMAD.IADD on the FMA
# pipe too (17 of them there), so only these 42 bound the time from below
THREEFRY_INT_OPS = 20 + 20 + 2
MAIN_N, MAIN_DEG, MAIN_P = 1024, 5, 579_594  # GN-LeNet width 32
MAIN_K = int(0.1 * MAIN_P)  # the TopK payload at a 10% budget: 57,959
LIBS = ("gossip_mix", "scatter_gossip", "sparsify", "quantize", "secure_mask",
        "swa_attention", "ssd_chunk")
SECURE_CFG = dict(secure=True, participation=0.9, secure_recovery=True)
# the [faults] path's plan: msg_loss within examples/faults.py's sweep, its
# --corrupt 0.05, tests/test_faults.py's crash windows
FAULT_PLAN = dict(msg_loss=0.1, latency_spike_prob=0.05, latency_spike_factor=10.0,
                  corrupt_prob=0.05, corrupt_mode="nan", crashes=((3, 2, 5), (7, 4, -1)), seed=0)
CMP_ELEMS = 1 << 28  # elements per step of a kernel-twin comparison
L2_EVICT_BYTES = 256 << 20  # a write over this many bytes clears the 50 MB L2
YARDSTICK_KEYS = ("searchsorted_", "code_pass_")  # check()'s further yardsticks
PASS_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
             "device_recorded", "device_launched", "searchsorted_ms", "searchsorted_device_ms")
# further checks of a kernel kept under its JSON entry: the fine histogram
# pass, the quantize noise form, and the callers of the sampled strategies
FORMS = ("fine_pass", "noise_form", "dynamic_table", "randk_rows", "strided_rows", "prng_noise",
         "full_width", "cohort_rows", "cold_rows", "block_rows")
PROFILER_BOOKKEEPING = ("Activity Buffer Request", "Buffer Flush")  # the profiler's own
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: device_times' padding
NO_LIBRARY = ("none: no PyTorch call draws Threefry counter bits or maps them to signed "
              "masks; the plain twin composes some 180 integer ops per pass")


def time_ms(fn, iters=10, warmup=2, min_window_ms=20.0):
    """Mean device milliseconds per call, from CUDA events around
    back-to-back calls: ``iters`` calls, or as many more as fill a window
    of ``min_window_ms`` (ten calls of a few microseconds each measure the
    host's noise more than the call)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    while True:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end)
        if total >= min_window_ms:
            return total / iters
        iters = math.ceil(iters * 1.2 * min_window_ms / max(total, 1e-3))


def merge_bound_ms(n, k, p, item, x_rows):
    """Least time for out[n] = sum_k w[n,k] X[rows[n,k]]: X's ``x_rows``
    rows read once, the (n, k) index and weight tables read once, out
    written once, against 2*k*n*p fp32 operations; the larger of the two."""
    return bound_ms(x_rows * p * item + n * k * 8 + n * p * item, 2 * k * n * p)


def bound_ms(nbytes, ops, rate=FP32_FLOPS):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate for their type (fp32 unless named), the
    larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def own_kernel_names():
    """The names of the kernels that the port's CUDA sources define."""
    names = set()
    for src in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    return names


def device_times(fn, wrappers=None, iters=10, attempts=6, pad=16, evict=None):
    """Device time per call of ``fn`` from torch.profiler, over ``iters``
    calls after one warm-up call (each after ``evict()`` where given: a
    write that clears the L2 cache of ``fn``'s operands, its kernels left
    out of ``ms``), as a dict: ``ms`` (the port's own
    kernels; every kernel when ``wrappers`` is None, as for a library
    call), ``other_ms`` (any other device activity), ``recorded`` and
    ``launched`` (the kernel records ``ms`` stands on, and the launches it
    should) and ``kernels`` (the names any window recorded).

    ``launched`` is what the counters of ``wrappers`` (the names of the
    wrappers that launch ``fn``'s kernels) moved in the window, or, for a
    library call, ``iters`` times the records of one call.  The profiler
    can lose kernel records of a window, the first ones (on one H100, late
    in a long process, from 1 in 10 to all of them), so each window opens
    with ``pad`` launches of ``torch.cuda._sleep``'s kernel, left out of
    every sum, and up to ``attempts`` windows are tried, ``pad`` growing
    fourfold, until one records every launch.  Then
    a window of the port's kernels that still keeps fewer than half of
    them is refused, one that keeps more gives the kept records' mean
    times the launches; a library call's ``ms`` is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    own_names = own_kernel_names()

    def window(calls, pad):
        before = read_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(1)
            for _ in range(calls):
                if evict is not None:
                    evict()
                fn()
            torch.cuda.synchronize()
        after = read_launches()
        launched = sum(after[w] - before[w] for w in wrappers or ())
        mine = other = 0.0
        recorded, names = 0, set()
        for e in prof.events():
            if (e.device_type != DeviceType.CUDA or e.name in PROFILER_BOOKKEEPING
                    or PAD_KERNEL in e.name):
                continue
            if wrappers is None or any(n in e.name for n in own_names):
                mine, recorded = mine + e.time_range.elapsed_us(), recorded + 1
            else:
                other += e.time_range.elapsed_us()
            names.add(e.name[:90])
        return launched, recorded, mine, other, names

    fn()
    torch.cuda.synchronize()
    seen = set()  # every kernel name any window recorded
    for _ in range(attempts):
        launched, recorded, mine, other, names = window(iters, pad)
        seen |= names
        if wrappers is None:
            launched = iters * window(1, pad)[1]
        if launched and recorded == launched:
            break
        print(f"[kernel] the profiler kept {recorded} records of {launched} launches after "
              f"{pad} padding launches; again with {4 * pad}", flush=True)
        pad *= 4
    if launched and recorded == launched:
        scale = 1.0
    elif wrappers is not None and recorded < launched <= 2 * recorded:
        scale = launched / recorded
    elif wrappers is None:  # a library call whose records did not repeat per call
        scale = None
    else:
        raise AssertionError(f"torch.profiler kept {recorded} kernel records of {launched} "
                             f"launches: not a count to time by")

    def per_call(us):
        return None if scale is None else us * scale / iters / 1e3

    return {"ms": per_call(mine), "other_ms": per_call(other),
            "recorded": recorded, "launched": launched, "kernels": sorted(seen)}


def sdpa_backend(names):
    """Which backend of scaled_dot_product_attention the kernel names show."""
    if not names:
        return "not recorded"
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("cutlassf", "efficient")):
        if key in text:
            return backend
    return "math"


def check(label, kernel, twin, library, bound, tol=None, library_covers=None, plain_iters=3,
          yardsticks=None, l2_resident=False):
    """Run the kernel and its twin once on the same inputs and hold every
    output together: bitwise when ``tol`` is None, else
    |k - t| <= tol + tol * |t| everywhere.  Time the kernel, the twin
    (``plain_iters`` calls after one warm-up, or one call without) and the
    one-call library yardstick (``library_covers`` says what it computes)
    by CUDA events around back-to-back calls, which count the wrapper's
    host cost where it exceeds the device's; then, from torch.profiler
    (``device_times``), the kernel's own device time per call
    (``device_ms``; the wrapper's other device work, if any, as
    ``device_other_ms``), with the kernel records it stands on and the
    launches of the wrappers that the first call moved
    (``device_recorded``, ``device_launched``), and each yardstick's device
    time and the names of the kernels it ran (its backend).
    ``yardsticks`` names further one-call yardsticks, timed the same
    way.  ``l2_resident``: the operands fit in the 50 MB L2, where
    back-to-back calls find them (``device_ms`` is then an L2 reading);
    ``device_evicted_ms`` is the device time with the L2 cleared before
    each launch by a write over a 256 MiB scratch buffer (not counted)."""
    import torch

    before = read_launches()
    got = kernel()
    wrappers = [w for w, n in read_launches().items() if n != before[w]]
    if not wrappers:
        raise AssertionError(f"{label}: no kernel wrapper launched")
    want = twin()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    ok, max_abs, scale = True, 0.0, 0.0
    for a, b in zip(got, want):
        if tol is None:
            ok = ok and torch.equal(a, b)
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), CMP_ELEMS):  # bounded temporaries
            x, y = a[i:i + CMP_ELEMS].float(), b[i:i + CMP_ELEMS].float()
            err = (x - y).abs()
            max_abs = max(max_abs, float(err.max()))
            scale = max(scale, float(y.abs().max()))
            if tol is not None:
                ok = ok and bool((err <= tol + tol * y.abs()).all())
            del x, y, err
    del got, want
    rec = {"max_abs_err": max_abs}
    if tol is not None:
        rec["max_rel_err"] = max_abs / scale  # against the output's scale
    rec.update({
        "ms": time_ms(kernel),
        "plain_ms": time_ms(twin, iters=plain_iters, warmup=1 if plain_iters > 1 else 0),
        "library_ms": time_ms(library) if library is not None else None,
        "bound_ms": bound[0], "bound_by": bound[1],
    })
    dev = device_times(kernel, wrappers)
    rec.update({"device_ms": dev["ms"], "device_other_ms": dev["other_ms"],
                "device_recorded": dev["recorded"], "device_launched": dev["launched"]})
    if l2_resident:
        scratch = torch.empty(L2_EVICT_BYTES, dtype=torch.uint8, device="cuda")
        cold = device_times(kernel, wrappers, evict=lambda: scratch.fill_(1))
        rec.update({"device_l2": "hot: back-to-back calls, operands L2-resident",
                    "device_evicted_ms": cold["ms"],
                    "device_evicted_recorded": cold["recorded"]})
        del scratch
    for key, fn in (("library", library), *(yardsticks or {}).items()):
        if fn is None:
            continue
        if key != "library":
            rec[f"{key}_ms"] = time_ms(fn)
        dev = device_times(fn)
        rec[f"{key}_device_ms"], rec[f"{key}_kernels"] = dev["ms"], dev["kernels"]
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
    out["gossip_mix"] = check(
        f"gossip_mix fp32 K={k} M={p}",
        lambda: gm.gossip_mix(x1, w1),
        lambda: gm.gossip_mix_rows_ref(
            x1, torch.arange(k, dtype=torch.int32, device=dev)[None], w1[None]
        )[0],
        lambda: w1 @ x1,
        merge_bound_ms(1, k, p, 4, k), tol=1e-5, l2_resident=True,
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


def fine_edges(a, k, coarse, nbins=128):
    """The linear edges of ``topk_threshold_rows``'s second pass, inside
    the coarse bin its first pass picks (one histogram launch)."""
    import torch
    from repro_torch.kernels import sparsify as sp

    span = sp._span(nbins, a.device)[None, :]
    t0, t0_hi = sp._pick_edge_rows(a, k, coarse)
    fine = t0[:, None] * (1.0 - span) + torch.maximum(t0_hi, t0 + 1e-30)[:, None] * span
    return fine.contiguous()


def code_pass_yardstick(val):
    """``torch.quantize_per_channel`` of ``val`` (R, C) on its precomputed
    scales (the code pass alone, no absmax), as a yardsticks entry, or
    None where this PyTorch build has no CUDA kernel for it."""
    import torch
    from repro_torch.kernels import quantize as q

    scale = q.quantize_ref(val)[1][:, 0].double()
    zero = torch.zeros(val.shape[0], dtype=torch.int64, device=val.device)

    def fn():
        return torch.quantize_per_channel(val, scale, zero, 0, torch.qint8)

    try:
        fn()
    except (RuntimeError, NotImplementedError) as err:
        print(f"[kernel] torch.quantize_per_channel does not run on the card: "
              f"{str(err).splitlines()[0]}", flush=True)
        return None
    return {"code_pass": fn}


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

    # histogram: |delta| of a TopK round, in both passes of the top-k
    # threshold: its coarse log edges (with one row of non-monotone edges:
    # a fine edge one ulp below its left neighbour), then the fine linear
    # edges inside the coarse bin the path picks from them
    delta = torch.randn((n, p), generator=gen, device=dev) * torch.rand(
        (n, 1), generator=gen, device=dev)
    edges = log_edges(delta)
    fine = fine_edges(delta, k, edges)
    edges[7, 40] = torch.nextafter(edges[7, 39], torch.zeros((), device=dev))
    for label, e in (("coarse", edges), ("fine", fine)):
        h = sp.abs_histogram_rows_ref(delta[:64], e[:64])
        print(f"[kernel] abs_histogram_rows {label} pass, rows 0-63: bucket 0 holds "
              f"{float(h[:, 0].sum()) / h.sum().item():.4f} of the elements, bucket E "
              f"{float(h[:, -1].sum()) / h.sum().item():.4f}, {int((h > 0).sum(1).float().mean())} "
              f"non-empty buckets per row on average", flush=True)
    search = {"searchsorted": lambda: torch.searchsorted(edges, delta.abs(), right=True)}
    out["abs_histogram_rows"] = check(
        f"abs_histogram_rows coarse N={n} P={p} E=128",
        lambda: sp.abs_histogram_rows(delta, edges),
        lambda: sp.abs_histogram_rows_ref(delta, edges),
        lambda: torch.topk(delta.abs(), k, dim=1),
        hist_bound(n, p, 128), library_covers="torch.topk(|x|, k): the whole selection; "
        "searchsorted: torch.searchsorted(edges, |x|, right=True), the bucket search alone",
        yardsticks=search,
    )
    search = {"searchsorted": lambda: torch.searchsorted(fine, delta.abs(), right=True)}
    out["abs_histogram_rows"]["fine_pass"] = check(
        f"abs_histogram_rows fine N={n} P={p} E=128",
        lambda: sp.abs_histogram_rows(delta, fine),
        lambda: sp.abs_histogram_rows_ref(delta, fine),
        None, hist_bound(n, p, 128), yardsticks=search,
        library_covers="searchsorted: torch.searchsorted(edges, |x|, right=True), the bucket "
                       "search alone")
    del search, fine
    dr = torch.randn((37, 1001), generator=gen, device=dev)
    er = log_edges(dr)
    check("abs_histogram_rows N=37 P=1001 E=128", lambda: sp.abs_histogram_rows(dr, er),
          lambda: sp.abs_histogram_rows_ref(dr, er), None, hist_bound(37, 1001, 128))
    x1 = delta[0].clone()
    out["abs_histogram"] = check(
        f"abs_histogram M={p} E=128", lambda: sp.abs_histogram(x1, edges[0]),
        lambda: sp.abs_histogram_rows_ref(x1[None], edges[:1])[0], None,
        hist_bound(1, p, 128), library_covers="none: no PyTorch call counts |x| into "
                                              "per-row bins of arbitrary edges",
        l2_resident=True)

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
    codes_only = code_pass_yardstick(val)
    out["quantize"] = check(
        f"quantize N={n} k={k}", lambda: q.quantize(val), lambda: q.quantize_ref(val),
        None, codec_bound(n, k, False), yardsticks=codes_only,
        library_covers="code_pass: torch.quantize_per_channel on precomputed scales, the "
                       "code pass alone" if codes_only else None)
    del codes_only
    out["quantize"]["noise_form"] = check(
        f"quantize noise N={n} k={k}", lambda: q.quantize(val, noise),
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
    # (exact values, self slot dropped, K=5), bitwise; on the selector's
    # rows, sorted by index (the path's call, sorted_idx=True), and on the
    # same payloads with each row shuffled (the wrapper sorts them first);
    # two launches bitwise equal
    from repro_torch.core.topology import SparseTopology

    st = SparseTopology.regular_circulant(n, MAIN_DEG).to(dev)
    perm = torch.rand((n, k), generator=gen, device=dev).argsort(1)
    for label, v, self_slot in (("int8 wire", valq, True), ("fp32 wire", val, False)):
        rows, w = st.merge_tables(include_self=self_slot)
        s_ = rows.shape[1]
        a = sg.payload_mix_rows(X, idx, v, rows, w, sorted_idx=True)
        b = sg.payload_mix_rows(X, idx, v, rows, w, sorted_idx=True)
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
            f"payload_mix_rows {label} sorted N={n} P={p} K={s_} k={k}",
            lambda: sg.payload_mix_rows(X, idx, v, rows, w, sorted_idx=True),
            lambda: sg.payload_mix_rows_ref(X, idx, v, rows, w),
            lambda: Y.view(-1).index_add_(0, flat, contrib),
            payload_bound(n, p, n, k, s_),
            library_covers="index_add_ of precomputed contributions: the scatter alone",
        )
        out.setdefault("payload_mix_rows", rec)
        del flat, contrib, Y
        ish, vsh = idx.gather(1, perm), v.gather(1, perm)
        check(f"payload_mix_rows {label} unsorted N={n} P={p} K={s_} k={k}",
              lambda: sg.payload_mix_rows(X, ish, vsh, rows, w),
              lambda: sg.payload_mix_rows_ref(X, ish, vsh, rows, w), None,
              payload_bound(n, p, n, k, s_))
        del ish, vsh
    del perm
    nr, pr, kr = 33, 1003, 100
    Xr = torch.randn((nr, pr), generator=gen, device=dev)
    ir = torch.rand((nr, pr), generator=gen, device=dev).argsort(1)[:, :kr].int().contiguous()
    vr2 = torch.randn((nr, kr), generator=gen, device=dev)
    rr, wr = SparseTopology.regular_circulant(nr, 4).to(dev).merge_tables()
    check(f"payload_mix_rows unsorted N={nr} P={pr} K=5 k={kr}",
          lambda: sg.payload_mix_rows(Xr, ir, vr2, rr, wr),
          lambda: sg.payload_mix_rows_ref(Xr, ir, vr2, rr, wr), None,
          payload_bound(nr, pr, nr, kr, 5))
    del X, val, valq, idx
    torch.cuda.empty_cache()
    return out


def int32_rate():
    """(INT32 operations per second, SMs, max SM clock in MHz): 64 lanes per
    SM and clock at the SM count and the maximum SM clock the card reports."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    return INT32_LANES_PER_SM * sms * mhz * 1e6, sms, mhz


def keyed_bound(b, m, calls, int_rate):
    """x's rows read and out written once (bytes) against the integer-ALU
    instructions of this run's cipher calls, one call per lane and nonzero
    slot; the larger of the two."""
    t_bytes = 2 * b * m * 4 / HBM_BYTES_PER_S
    t_ops = calls * THREEFRY_INT_OPS / int_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def staged_bound(m, signs):
    """x read and out written once, and the bits of the nonzero slots
    (the kernel never reads a zero slot's bits); a shift, a conversion,
    three multiplies and two adds per bit word it reads."""
    b, nnz = signs.shape[0], int((signs != 0).sum())
    return bound_ms(b * m * 8 + nnz * m * 4, 7 * nnz * m)


def mask_bound(m):
    """x read, the values and the byte mask written; an abs, a compare and
    a select per element."""
    return bound_ms(m * 9, 3 * m)


def random_words(shape, gen, dtype):
    import torch

    lo, hi = (0, 1 << 32) if dtype == torch.int64 else (-(1 << 31), 1 << 31)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)


def phase_secure_kernels(int_rate):
    """The secure-mask kernels and the threshold mask against their twins:
    the keyed kernel on every message of a secure round at N=1024 (B=5120,
    K=5, M=579,594: the engine's rows, keys and signs), the staged one at
    B=1024 (the (5120, 5, M) bit stack would not fit), the threshold mask at
    M=P and at N·P flattened, and ragged shapes of each."""
    import torch
    from repro_torch import prng
    from repro_torch.core.secure import SecureAggregation
    from repro_torch.core.topology import Graph
    from repro_torch.kernels import secure_mask as sm
    from repro_torch.kernels import sparsify as sp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    n, p, d = MAIN_N, MAIN_P, MAIN_DEG
    out = {}
    s = SecureAggregation(Graph.regular_circulant(n, d).adj)
    rows, keys, signs = s.message_tables(prng.fold_in(prng.key(17), 3), 3, dev)
    X = torch.randn((n, p), generator=gen, device=dev)
    b = rows.numel()
    calls = int((signs != 0).sum()) * ((p + 1) // 2)
    print(f"[kernel] keyed secure mask: {calls} cipher calls, {THREEFRY_INT_OPS} integer-ALU "
          f"instructions each, at {int_rate:.6g} INT32 ops/s", flush=True)
    out["secure_mask_apply_rows_keyed"] = check(
        f"secure_mask_apply_rows_keyed B={b} K={d} M={p}",
        lambda: sm.secure_mask_apply_rows_keyed(X, rows, keys, signs),
        lambda: sm.secure_mask_apply_rows_keyed_ref(X, rows, keys, signs),
        None, keyed_bound(b, p, calls, int_rate), tol=1e-6, plain_iters=1,
        library_covers=NO_LIBRARY,
    )
    del X
    torch.cuda.empty_cache()
    # the masks themselves, bitwise: x = 0, one key, sign +1, odd and even M
    for bb, m in ((37, 1003), (5, 1), (3, 4096)):
        kk = random_words((bb, 1, 2), gen, torch.int64)
        z, one = torch.zeros((bb, m), device=dev), torch.ones((bb, 1), device=dev)
        check(f"secure mask bits B={bb} M={m}",
              lambda: sm.secure_mask_apply_rows_keyed(z, None, kk, one, 0.7),
              lambda: sm.mask_bits_to_uniform(
                  prng.counter_bits(kk[:, 0, 0:1], kk[:, 0, 1:2], m), 0.7),
              None, keyed_bound(bb, m, bb * ((m + 1) // 2), int_rate))
    # ragged: rows by index, zero signs, 37 messages
    xr = torch.randn((9, 1003), generator=gen, device=dev)
    rr = torch.randint(0, 9, (37,), generator=gen, device=dev, dtype=torch.int32)
    kr = random_words((37, 6, 2), gen, torch.int64)
    sr = torch.randint(-1, 2, (37, 6), generator=gen, device=dev).float()
    check("secure_mask_apply_rows_keyed B=37 K=6 M=1003",
          lambda: sm.secure_mask_apply_rows_keyed(xr, rr, kr, sr),
          lambda: sm.secure_mask_apply_rows_keyed_ref(xr, rr, kr, sr), None,
          keyed_bound(37, 1003, int((sr != 0).sum()) * 502, int_rate), tol=1e-6)

    xs = torch.randn((n, p), generator=gen, device=dev)
    bits = random_words((n, d, p), gen, torch.int32)
    ss = signs[:n].contiguous()
    out["secure_mask_apply_rows"] = check(
        f"secure_mask_apply_rows B={n} K={d} M={p}",
        lambda: sm.secure_mask_apply_rows(xs, None, bits, ss),
        lambda: sm.secure_mask_apply_rows_ref(xs, None, bits, ss),
        None, staged_bound(p, ss), tol=1e-6,
        library_covers="none: no PyTorch call maps uint32 bits to signed masks and sums them",
    )
    # the flat (M,) form: one message's K=5 slots
    x1, b1, s1 = xs[0].clone(), bits[0].clone(), ss[0].clone()
    del xs, bits
    torch.cuda.empty_cache()
    out["secure_mask_apply"] = check(
        f"secure_mask_apply K={d} M={p}", lambda: sm.secure_mask_apply(x1, b1, s1),
        lambda: sm.secure_mask_apply_rows_ref(x1[None], None, b1[None], s1[None])[0],
        None, staged_bound(p, s1[None]), tol=1e-6, l2_resident=True,
        library_covers="none: no PyTorch call maps uint32 bits to signed masks and sums them")
    br = random_words((37, 6, 1003), gen, torch.int32)
    check("secure_mask_apply_rows B=37 K=6 M=1003",
          lambda: sm.secure_mask_apply_rows(xr, rr, br, sr),
          lambda: sm.secure_mask_apply_rows_ref(xr, rr, br, sr), None,
          staged_bound(1003, sr), tol=1e-6)

    # the threshold mask, at the histogram selection's own thresholds
    x1 = torch.randn(p, generator=gen, device=dev)
    t1 = sp.topk_threshold(x1, MAIN_K)
    out["threshold_mask"] = check(
        f"threshold_mask M={p}", lambda: sp.threshold_mask(x1, t1),
        lambda: sp.threshold_mask_ref(x1, t1), None, mask_bound(p), l2_resident=True,
        library_covers="none: no one PyTorch call returns both the kept values and the mask")
    xf = torch.randn(n * p, generator=gen, device=dev)
    tf = sp.topk_threshold(xf, n * MAIN_K)
    check(f"threshold_mask M={n * p}", lambda: sp.threshold_mask(xf, tf),
          lambda: sp.threshold_mask_ref(xf, tf), None, mask_bound(n * p))
    xo = torch.randn(1003, generator=gen, device=dev)
    xo[17] = float("nan")
    check("threshold_mask M=1003 with a NaN", lambda: sp.threshold_mask(xo, 0.5),
          lambda: sp.threshold_mask_ref(xo, 0.5), None, mask_bound(1003))
    del xf
    torch.cuda.empty_cache()
    return out


def phase_entry_points():
    """The reference's stand-alone entry points as a user calls them, with
    the launch counts read around these calls alone: ``topk_mask_approx``
    on one node's P parameters (two histogram launches, one mask launch),
    the stacked staged form on 64 messages and its flat form (one staged
    launch each), the stacked keyed form (one keyed launch), and the flat
    (N=1) forms ``abs_histogram`` and ``gossip_mix`` (K=6) on one node's
    row (one launch each).  Returns the counts of the whole phase and, for
    each flat form, the launches read around its call alone."""
    import torch
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import secure_mask as sm
    from repro_torch.kernels import sparsify as sp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    p, d = MAIN_P, MAIN_DEG
    x = torch.randn(p, generator=gen, device=dev)
    xs = torch.randn((64, p), generator=gen, device=dev)
    bits = random_words((64, d, p), gen, torch.int32)
    keys = random_words((64, d, 2), gen, torch.int64)
    signs = torch.randint(-1, 2, (64, d), generator=gen, device=dev).float()
    edges = log_edges(x[None].abs())[0]
    w6 = torch.rand(d + 1, generator=gen, device=dev)
    torch.cuda.synchronize()

    def counted(wrapper, fn):
        before = read_launches()[wrapper]
        res = fn()
        torch.cuda.synchronize()
        return res, read_launches()[wrapper] - before

    reset_launches()
    vals, mask, t = sp.topk_mask_approx(x, MAIN_K)
    y = sm.secure_mask_apply_nodes(xs, bits, signs)
    y1, flat_apply = counted("secure_mask_apply_rows",
                             lambda: sm.secure_mask_apply(xs[0], bits[0], signs[0]))
    yk = sm.secure_mask_apply_nodes_keyed(xs, keys, signs)
    hist, flat_hist = counted("abs_histogram_rows", lambda: sp.abs_histogram(x, edges))
    mixed, flat_mix = counted("gossip_mix_rows", lambda: gm.gossip_mix(xs[:d + 1], w6))
    torch.cuda.synchronize()
    launches = read_launches()
    flat = {"secure_mask_apply": flat_apply, "abs_histogram": flat_hist, "gossip_mix": flat_mix}
    print(f"[entry] launches={launches}; flat forms alone {flat}; kept {int(mask.sum())} of "
          f"{p} at t={float(t)}", flush=True)
    want = {**{k: 0 for k in launches}, "abs_histogram_rows": 3, "threshold_mask": 1,
            "secure_mask_apply_rows": 2, "secure_mask_apply_rows_keyed": 1, "gossip_mix_rows": 1}
    if launches != want or set(flat.values()) != {1}:
        raise AssertionError(f"entry-point launches {launches}, want {want}; flat forms {flat}")
    if not (int(mask.sum()) >= MAIN_K and torch.equal(vals, torch.where(mask, x, 0.0))):
        raise AssertionError("topk_mask_approx kept too few or wrong values")
    if not (torch.equal(y1, y[0]) and bool(torch.isfinite(y).all() and torch.isfinite(yk).all())):
        raise AssertionError("secure mask entry points disagree or are not finite")
    if not (int(hist.sum()) == p and mixed.shape == (p,) and bool(torch.isfinite(mixed).all())):
        raise AssertionError("abs_histogram miscounted, or gossip_mix is not finite")
    return launches, flat


def phase_secure_path():
    """Secure aggregation with the seed-recovery pass under churn
    (participation 0.9) on the main path's configuration: per round two
    keyed launches (the N·D masked messages, then the dropped pairs' masks
    subtracted in place), one gather-merge launch (each receiver's live
    messages summed) and no other kernel; bytes as the host formula gives
    them, recovery bytes included."""
    import numpy as np
    from repro_torch.core.topology import circulant_neighbor_table

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           **SECURE_CFG)
    print(f"[secure] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"wire={eng.wire_dtype} share_stage_bytes={eng.share_stage_bytes}", flush=True)
    rounds = eng.dl.rounds
    hist, launches = drive_path("secure", eng, {"secure_mask_apply_rows_keyed": 2 * rounds,
                                                "gossip_mix_rows": rounds})
    # the host formula: live edges over live nodes (fp32), times P·4·1.03
    # folded into one fp32 constant, plus 32 bytes per (live receiver, live
    # sender, dropped co-neighbour) triple
    nbr = circulant_neighbor_table(MAIN_N, MAIN_DEG)
    f32 = np.float32
    total, rec_total = 0.0, 0.0
    for m in eng.scheduler.participation_mask(0, rounds):
        mn = m[nbr]
        deg = f32((m[:, None] * mn).sum()) / f32(m.sum())
        rec = f32(32) * f32((m * mn.sum(1) * (1.0 - mn).sum(1)).sum())
        total += float(deg * f32(f32(MAIN_P * 4) * f32(1.03)) + rec)
        rec_total += float(rec)
    print(f"[secure] bytes_sent={eng.bytes_sent} (host formula {total}); recovery_bytes="
          f"{hist[-1]['recovery_bytes']} (host formula {rec_total})", flush=True)
    if eng.bytes_sent != total or hist[-1]["recovery_bytes"] != rec_total:
        raise AssertionError("secure path bytes differ from the host formula")
    return launches, eng


def main_path_engine(n, width, n_train, rounds, chunk, eval_every, device, init_params=None,
                     optimizer=("sgd", 0.05, {}), local_steps=2, **sharing):
    """The quickstart configuration (5-regular unless ``topology`` is
    given, LAN model, ``local_steps`` of batch 8, GN-LeNet) with the sharing,
    overlay, churn and fault knobs of ``sharing`` (``faults`` a FaultPlan
    or its keyword dict); ``optimizer`` is ``make_optimizer``'s (name, lr,
    kwargs)."""
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.models.cnn import cnn_init
    from repro_torch.optim import make_optimizer
    from repro_torch.quickstart import acc_fn, loss_fn

    from repro_torch.core.faults import FaultPlan

    if isinstance(sharing.get("faults"), dict):
        sharing = {**sharing, "faults": FaultPlan(**sharing["faults"])}
    ds = make_dataset("cifar10", n_train=n_train, n_test=512)
    parts = sharding_partition(ds.train_y, n, shards_per_node=2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, batch_size=8, seed=0)
    dl = DLConfig(**{**dict(sharing="full", topology="regular"), **sharing}, n_nodes=n,
                  degree=MAIN_DEG, local_steps=local_steps, batch_size=8, rounds=rounds,
                  chunk_rounds=chunk, eval_every=eval_every, network="lan")
    name, lr, okw = optimizer
    return RoundEngine(dl, lambda g: cnn_init(g, width=width), loss_fn, acc_fn,
                       make_optimizer(name, lr, **okw), batcher,
                       init_params=init_params, device=device)


def drive_path(path, eng, want):
    """Run the engine's rounds with every kernel's launch count set to 0
    just before and read just after, and hold the counts to ``want`` (the
    kernels not named there: 0); check finite results and print rounds/s
    (the rounds after the first chunk, evaluations included) and peak
    device memory.  Returns the history and the counts."""
    import torch

    assert eng.n_params == MAIN_P, eng.n_params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist = eng.run(log=True)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[{path}] launches={launches}", flush=True)
    want = {**{k: 0 for k in launches}, **want}
    if launches != want:
        raise AssertionError(f"{path} path launches {launches}, want {want}")
    if not (eng.sim_time_s > 0 and all(math.isfinite(h["acc_mean"]) for h in hist)):
        raise AssertionError(f"sim_time_s {eng.sim_time_s} or non-finite acc_mean in {hist}")
    if not bool(torch.isfinite(eng.X).all()):
        raise AssertionError(f"non-finite parameters after the {path} path")
    span = hist[-1]["round"] - hist[0]["round"]
    rps = span / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    print(f"[{path}] rounds/s after the first chunk (evals included): {rps:.4f}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
          f"bytes_sent={eng.bytes_sent} sim_time_s={eng.sim_time_s} "
          f"acc_mean={[h['acc_mean'] for h in hist]}", flush=True)
    return hist, launches


def phase_main_path():
    """Full sharing: one gather-merge launch per round."""
    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None)
    print(f"[main] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"mix_mode={eng.mix_mode}", flush=True)
    rounds = eng.dl.rounds
    _, launches = drive_path("main", eng, {"gossip_mix_rows": rounds})
    want_bytes = rounds * MAIN_DEG * MAIN_P * 4
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    return launches, eng


def kernel_wrappers():
    """Each kernel's wrapper, which counts the kernel's launches."""
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import scatter_gossip as sg
    from repro_torch.kernels import secure_mask as sm
    from repro_torch.kernels import sparsify as sp
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.kernels import swa_attention as swa

    return {"abs_histogram_rows": sp.abs_histogram_rows, "quantize": q.quantize,
            "dequantize": q.dequantize, "payload_mix_rows": sg.payload_mix_rows,
            "gossip_mix_rows": gm.gossip_mix_rows, "threshold_mask": sp.threshold_mask,
            "secure_mask_apply_rows_keyed": sm.secure_mask_apply_rows_keyed,
            "secure_mask_apply_rows": sm.secure_mask_apply_rows,
            "swa_attention_gqa": swa.swa_attention_gqa, "ssd_chunk": ssd.ssd_chunk}


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def phase_topk_path():
    """TopK sharing at a 10% budget with int8 payloads on the main path's
    configuration: per round two histogram launches, one quantize, one
    dequantize, one payload merge and no gather merge."""
    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           sharing="topk", budget=0.1, payload_quant=True)
    print(f"[topk] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"k={MAIN_K} wire={eng.wire_dtype} share_stage_bytes={eng.share_stage_bytes}",
          flush=True)
    rounds = eng.dl.rounds
    _, launches = drive_path("topk", eng, {
        "abs_histogram_rows": 2 * rounds, "quantize": rounds, "dequantize": rounds,
        "payload_mix_rows": rounds})
    want_bytes = rounds * MAIN_DEG * (MAIN_K * 5 + 4)
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    return launches, eng


def host_churn_rounds(eng, rounds):
    """Per round of the run just driven, on the host: the activity mask
    (churn ANDed with crash windows), the sending edges of the 5-regular
    overlay (both endpoints up) and the churn-level degree as the engine's
    fp32 division gives it."""
    import numpy as np
    from repro_torch.core.topology import circulant_neighbor_table

    nbr = circulant_neighbor_table(MAIN_N, MAIN_DEG)
    act, _ = eng.scheduler.stage_activity(0, rounds)
    out = []
    for m in act:
        up = m > 0
        sent = up[:, None] & up[nbr]
        deg = np.float32(np.count_nonzero(sent)) / np.float32(max(np.count_nonzero(up), 1))
        out.append((up, sent, deg))
    return out


def phase_faults_path():
    """Full sharing under FAULT_PLAN (message loss 0.1, latency spikes
    0.05 x10, NaN corruption 0.05, crash windows (3, 2, 5) and (7, 4, -1))
    at participation 0.9: per round one gather-merge launch on that round's
    loss-reweighted table and no other kernel.  The counters conserve, the
    guard detects and rolls back every corruption, the crash windows take 7
    node-rounds, the dropped, spiked and corrupted counts equal those of
    the same draws recomputed on the CPU (``repro_torch.core.faults``), and
    the bytes are the churn-level host formula's (lost messages are still
    charged)."""
    import numpy as np
    import torch
    from repro_torch.core import faults
    from repro_torch.core.faults import FaultPlan

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           participation=0.9, faults=FaultPlan(**FAULT_PLAN))
    print(f"[faults] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"plan={FAULT_PLAN} participation=0.9", flush=True)
    rounds = eng.dl.rounds
    hist, launches = drive_path("faults", eng, {"gossip_mix_rows": rounds})
    plan, key = eng.dl.faults, faults.fault_key(eng.dl.faults, eng.dl.seed)
    ids = torch.arange(MAIN_N)
    lost = corrupted = 0
    total = 0.0
    for r, (up, sent, deg) in enumerate(host_churn_rounds(eng, rounds)):
        live, spike = faults.edge_draws(key, r, ids, MAIN_DEG, plan)
        lost += np.count_nonzero(sent & (live.numpy() == 0)) + np.count_nonzero(
            sent & (spike.numpy() > 0))
        corrupted += np.count_nonzero(up & (faults.corruption_mask(key, r, ids, plan).numpy() > 0))
        total += float(deg * np.float32(MAIN_P * 4))
    got = {k: hist[-1][k] for k in faults.STAT_KEYS}
    want = {"faults_injected": lost + corrupted + 7, "faults_detected": corrupted,
            "faults_survived": lost + 7, "faults_recovered": corrupted, "retry_total": 0,
            "recovery_bytes": 0.0}
    print(f"[faults] counters {got}; recomputed on the CPU {want} (messages lost or spiked "
          f"{lost}, rows corrupted {corrupted}, crash downtime 7); bytes_sent={eng.bytes_sent} "
          f"(host formula {total})", flush=True)
    if got != want or eng.bytes_sent != total or corrupted == 0 or lost == 0:
        raise AssertionError("faults path: counters or bytes differ from the CPU recomputation")
    return launches, eng


def time_guard(eng):
    """The guard's three passes over the engine's (N, P) state, CUDA-event
    timed: the start-of-round snapshot copy, the non-finite row pass and
    the rollback select."""
    import torch
    from repro_torch.core import faults

    X = eng.X
    snap = X.clone()
    good = torch.ones(X.shape[0], device=X.device)
    out = torch.empty_like(X)
    times = {"snapshot copy": time_ms(lambda: snap.copy_(X)),
             "non-finite rows": time_ms(lambda: faults.nonfinite_rows(X)),
             "rollback where": time_ms(lambda: torch.where(good[:, None] > 0, X, snap, out=out))}
    print(f"[faults] guard passes over ({X.shape[0]}, {X.shape[1]}) fp32 (CUDA events, ms per "
          f"pass): {times}", flush=True)
    del snap, out
    return times


def phase_churn_topk_path():
    """TopK at a 10% budget with the int8 wire under churn (participation
    0.9): ``[topk]``'s launch counts (two histogram launches, one
    quantize, one dequantize, one payload merge per round), bytes
    sum_r deg_eff_r (k·5 + 4) in fp32."""
    import numpy as np

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           sharing="topk", budget=0.1, payload_quant=True, participation=0.9)
    print(f"[churn-topk] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"k={MAIN_K} wire={eng.wire_dtype} participation=0.9", flush=True)
    rounds = eng.dl.rounds
    _, launches = drive_path("churn-topk", eng, {
        "abs_histogram_rows": 2 * rounds, "quantize": rounds, "dequantize": rounds,
        "payload_mix_rows": rounds})
    total = sum(float(deg * np.float32(MAIN_K * 5 + 4))
                for _, _, deg in host_churn_rounds(eng, rounds))
    print(f"[churn-topk] bytes_sent={eng.bytes_sent} (host formula {total})", flush=True)
    if eng.bytes_sent != total:
        raise AssertionError("churn-topk path bytes differ from the host formula")
    return launches, eng


def profile_churn_topk_round(eng):
    """One more round under the profiler, holding the down nodes'
    last_shared rows to be bitwise what they were before it."""
    import numpy as np
    import torch

    rnd = eng.dl.rounds
    act, _ = eng.scheduler.stage_activity(rnd, 1)
    down = torch.as_tensor(np.nonzero(act[0] == 0)[0], device=eng.device)
    last = eng.share_state["last_shared"]
    before, live_before = last[down].clone(), last[:64].clone()
    phase_profile(eng, "churn-topk")
    frozen = torch.equal(eng.share_state["last_shared"][down], before)
    moved = not torch.equal(eng.share_state["last_shared"][:64], live_before)
    print(f"[churn-topk] round {rnd}: {down.numel()} down nodes' last_shared rows bitwise "
          f"unchanged: {frozen}; the first 64 rows moved: {moved}", flush=True)
    if down.numel() == 0 or not frozen or not moved:
        raise AssertionError("churn-topk: a down node's last_shared changed (or none was down)")


def phase_sampled_kernels():
    """The kernels at the new callers' shapes and data, N=1024, P=579,594:
    the gather merge on a dynamic overlay's round table (K=6), the payload
    merge on uniform random-k rows (sorted after the stable top-k of
    Threefry uniforms) and on strided rows over the padded width (fp32
    wire, K=5, k=57,959), and the quantize kernel's noise form fed the
    per-node uniforms of a stochastic quant round, with dequantize, over
    the whole (N, P) state.  Also the uniform draw and the top-k sort
    alone (torch ops, no kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import prng
    from repro_torch.core import sharing as sh
    from repro_torch.core.topology import PeerSampler, SparseTopology, stage_rounds
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import scatter_gossip as sg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    n, p, k = MAIN_N, MAIN_P, MAIN_K
    out = {}
    X = torch.randn((n, p), generator=gen, device=dev)
    rows, w = stage_rounds(PeerSampler(n, MAIN_DEG, 0).sparse_stack(3, 1), dev)[0].merge_tables()
    out["dynamic_table"] = check(
        f"gossip_mix_rows fp32 N={n} K={rows.shape[1]} P={p} dynamic round table",
        lambda: gm.gossip_mix_rows(X, rows, w), lambda: gm.gossip_mix_rows_ref(X, rows, w),
        None, merge_bound_ms(n, rows.shape[1], p, 4, n), tol=1e-5)

    key = prng.fold_in(prng.key(17), 3)
    keys = sh._node_keys(key, n, dev)
    draw_ms = wall_ms(lambda: sh._randk_uniforms(key, (n, p), dev))
    u = sh._randk_uniforms(key, (n, p), dev)
    sort_ms = wall_ms(lambda: sh._randk_select(u, k))
    idx = sh._randk_select(u, k)
    calls = n * p
    print(f"[kernel] uniform draw (torch ops) N={n} P={p}: {calls} Threefry calls, wall ms "
          f"{draw_ms}; stable top-k sort and row sort k={k}: wall ms {sort_ms}", flush=True)
    out["draw_ms"], out["sort_ms"] = draw_ms, sort_ms
    st = SparseTopology.regular_circulant(n, MAIN_DEG).to(dev)
    rows5, w5 = st.merge_tables(include_self=False)
    val = X.gather(1, idx.long())
    out["randk_rows"] = check(
        f"payload_mix_rows fp32 wire random-k uniform rows N={n} P={p} K=5 k={k}",
        lambda: sg.payload_mix_rows(X, idx, val, rows5, w5, sorted_idx=True),
        lambda: sg.payload_mix_rows_ref(X, idx, val, rows5, w5), None,
        payload_bound(n, p, n, k, 5))
    del u, idx, val
    stride = -(-p // k)
    Xp = F.pad(X, (0, k * stride - p))
    phase = sh._strided_phase(key, n, stride, dev)
    sidx = (torch.arange(k, dtype=torch.int32, device=dev)[None] * stride + phase[:, None])
    sval = Xp.gather(1, sidx.long())
    out["strided_rows"] = check(
        f"payload_mix_rows fp32 wire strided rows N={n} P={k * stride} K=5 k={k} stride={stride}",
        lambda: sg.payload_mix_rows(Xp, sidx, sval, rows5, w5, sorted_idx=True),
        lambda: sg.payload_mix_rows_ref(Xp, sidx, sval, rows5, w5), None,
        payload_bound(n, k * stride, n, k, 5))
    del Xp, sidx, sval
    noise_ms = wall_ms(lambda: prng.uniform(keys, (p,)))
    noise = prng.uniform(keys, (p,))
    print(f"[kernel] stochastic rounding noise (torch ops) N={n} P={p}: wall ms {noise_ms}",
          flush=True)
    out["noise_ms"] = noise_ms
    out["prng_noise"] = check(
        f"quantize noise N={n} C={p} prng.uniform per-node noise",
        lambda: q.quantize(X, noise), lambda: q.quantize_ref(X, noise), None,
        codec_bound(n, p, True))
    codes, scale = q.quantize(X, noise)
    del noise
    out["full_width"] = check(
        f"dequantize N={n} C={p}", lambda: q.dequantize(codes, scale),
        lambda: q.dequantize_ref(codes, scale), None, codec_bound(n, p, False))
    del X, codes, scale
    torch.cuda.empty_cache()
    return out


def phase_dynamic_path():
    """Full sharing over the dynamic overlay (a new random 5-regular graph
    every round): one gather-merge launch per round, on that round's own
    table, bytes as the static overlay's; at least two rounds' tables
    differ."""
    import torch

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           topology="dynamic")
    print(f"[dynamic] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"mix_mode={eng.mix_mode}", flush=True)
    staged = []
    stage = eng.scheduler.stage_topology

    def recording_stage(start, n_rounds):
        ops = stage(start, n_rounds)
        staged.extend(W.merge_tables()[0].clone() for W, _ in ops)
        return ops

    eng.scheduler.stage_topology = recording_stage
    rounds = eng.dl.rounds
    _, launches = drive_path("dynamic", eng, {"gossip_mix_rows": rounds})
    eng.scheduler.stage_topology = stage
    want_bytes = rounds * MAIN_DEG * MAIN_P * 4
    differ = sum(not torch.equal(staged[0], t) for t in staged[1:])
    print(f"[dynamic] bytes_sent={eng.bytes_sent} (want {want_bytes}); {len(staged)} round "
          f"tables staged, {differ} differ from round 0's; topo_stage_bytes_peak="
          f"{eng.topo_stage_bytes_peak}", flush=True)
    if eng.bytes_sent != want_bytes or len(staged) != rounds or differ < 1:
        raise AssertionError("dynamic path: bytes, or the per-round tables, are wrong")
    return launches, eng


def phase_randomk_path():
    """Random-k sharing at a 10% budget (k = 57,959), uniform sampler, fp32
    payloads: one payload-merge launch per round (the self slot dropped,
    K=5) and no other kernel; the strided sampler's share step timed
    apart (stride 11, a 1-byte phase)."""
    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=4, chunk=4, eval_every=4, device=None,
                           sharing="randomk", budget=0.1)
    print(f"[randomk] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"k={MAIN_K} wire={eng.wire_dtype} share_stage_bytes={eng.share_stage_bytes}",
          flush=True)
    rounds = eng.dl.rounds
    _, launches = drive_path("randomk", eng, {"payload_mix_rows": rounds})
    want_bytes = rounds * MAIN_DEG * MAIN_K * 8
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    return launches, eng


def phase_quant_path():
    """Quantized full sharing with stochastic rounding: per round one
    quantize launch (noise form, per-node uniforms), one dequantize and one
    gather merge, and no other kernel; bytes P + 4 per neighbour."""
    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=4, chunk=4, eval_every=4, device=None,
                           sharing="quant")
    print(f"[quant] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params} "
          f"wire={eng.wire_dtype} share_stage_bytes={eng.share_stage_bytes}", flush=True)
    rounds = eng.dl.rounds
    _, launches = drive_path("quant", eng, {"quantize": rounds, "dequantize": rounds,
                                            "gossip_mix_rows": rounds})
    want_bytes = rounds * MAIN_DEG * (MAIN_P + 4)
    if eng.bytes_sent != want_bytes:
        raise AssertionError(f"bytes_sent {eng.bytes_sent} != {want_bytes}")
    return launches, eng


def time_sampled_share_step(eng, path):
    """The share step alone, then its random draw and (random-k) its
    selection sort alone, on the engine's state; for random-k also the
    strided sampler's share step (stride 11, a 1-byte phase)."""
    import dataclasses as dc

    from repro_torch import prng
    from repro_torch.core import sharing as sh

    times = {"share": time_share_step(eng, path)}
    rnd = eng.dl.rounds + 1
    key = prng.fold_in(eng.steps.base_key, rnd)
    n, p = eng.X.shape
    if path == "randomk":
        times["draw"] = wall_ms(lambda: sh._randk_uniforms(key, (n, p), eng.device))
        u = sh._randk_uniforms(key, (n, p), eng.device)
        times["sort"] = wall_ms(lambda: sh._randk_select(u, MAIN_K))
        del u
        strided = dc.replace(eng.sharing, sampler="strided")
        times["strided_share"] = time_share_step(eng, path, strategy=strided,
                                                 label="strided sampler share step alone")
    else:
        keys = sh._node_keys(key, n, eng.device)
        times["draw"] = wall_ms(lambda: prng.uniform(keys, (p,)))
    print(f"[{path}] share step breakdown (wall ms, synchronised): {times}", flush=True)
    return times


def share_operands(eng, rnd):
    """The share step's operands of round ``rnd`` as the scheduler stages
    them (the dynamic overlay's own table of that round), churn reweight
    and key included: (W, degree, key, kwargs)."""
    import torch

    act = None
    act_np, _ = eng.scheduler.stage_activity(rnd, 1)
    if act_np is not None:
        act = (torch.as_tensor(act_np[0], device=eng.device), act_np[0])
    W, live = eng.scheduler.stage_topology(rnd, 1)[0]
    return eng.steps.share_operands(W, rnd, act, live)


def wall_ms(fn, reps=3):
    """Device-synchronised wall milliseconds of ``reps`` calls of ``fn``."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        times.append((time.time() - t) * 1e3)
    return times


def time_share_step(eng, path, reps=3, strategy=None, label="share step alone"):
    """Device-synchronised wall ms of the strategy's (or ``strategy``'s)
    share step alone on the engine's state, for the round after the
    profiled one, churn reweight and key included (it advances the
    strategy state; run it last)."""
    import torch

    rnd = eng.dl.rounds + 1
    W, deg, key, kw = share_operands(eng, rnd)
    strategy = strategy or eng.sharing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = wall_ms(lambda: strategy.round(eng.X, W, eng.share_state, key=key, degree=deg,
                                           rnd=rnd, **kw), reps)
    print(f"[{path}] {label} (wall ms, synchronised): {times}; its peak "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B", flush=True)
    return times


def phase_profile(eng, path, top=12):
    """One more round of the engine's path (``path`` names it in the log)
    under torch.profiler."""
    profile_call(f"one {path}-path round",
                 lambda: eng.scheduler.run_span(eng.dl.rounds, 1), top)


def profile_call(label, fn, top=12):
    """``fn()`` under torch.profiler: the device's busy time (union of its
    kernel and copy intervals) against the call's wall time, and the device
    time by kernel (the ``top`` largest; every kernel where None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in PROFILER_BOOKKEEPING]
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
    print(f"[profile] {label} under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy (union of intervals) {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.4f}; sum of device times {sum_ms:.3f} ms",
          flush=True)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {tot / 1e3:10.3f} ms  x{cnt:<5d} {name[:100]}", flush=True)


class Recorder:
    """A strategy that keeps a CPU copy of each round's share-step inputs
    and outputs (X, the mixing operand it was given, state, key, degree,
    the participation mask or None, X', state', bytes): under churn the
    operand is the churn-reweighted one and the degree the round's own."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def round(self, X, W, state, key=None, degree=1.0, rnd=0, **kw):
        from repro_torch.core.topology import SparseTopology

        cpu = lambda st: {k: v.cpu().clone() for k, v in st.items()} if st else st
        Wc = (SparseTopology(W.nbr.cpu(), W.w.cpu(), W.w_self.cpu())
              if isinstance(W, SparseTopology) else W.cpu())
        act = kw["act"].cpu() if "act" in kw else None
        before = (X.cpu().clone(), Wc, cpu(state), key, degree, act)
        X2, state, nbytes = self.inner.round(X, W, state, key=key, degree=degree, rnd=rnd, **kw)
        self.log.append((*before, X2.cpu().clone(), cpu(state), nbytes))
        return X2, state, nbytes


# AdamW's step m / (sqrt(v) + eps) maps a gradient of 1e-12 to a step of
# order lr at a small eps, so an fp32 rounding of a near-zero gradient
# (cuDNN's against the CPU's) moves a parameter by ~lr; eps = 1e-3 keeps
# the step Lipschitz in the gradient (tests/test_torch_optim.py says the
# same of its engine run)
CHURN_FAULTS = dict(msg_loss=0.2, latency_spike_prob=0.2, corrupt_prob=0.2, seed=1)
# the scheduler phases' straggler model (examples/churn.py's flags): base
# compute 0.05 s, a tenth of the nodes 10x slower
SCHED_CFG = dict(compute_time_s=0.05, straggler_factor=10.0, straggler_frac=0.1)
# a cohort engine on a spread clock with a window (the hierarchy's regime)
COHORT_CFG = dict(semantics="async", batch_keying="node", compute_time_s=0.05,
                  compute_spread=3.0, async_slice_s=0.02)
# the [processes] phase: K worker processes sharing the card, N nodes in
# row blocks of N/K, GN-LeNet at the main path's width (P = 579,594)
PROC_N, PROC_K, PROC_ROUNDS, PROC_BUDGET = 256, 4, 6, 0.1
PROC_B, PROC_KP = PROC_N // PROC_K, int(PROC_BUDGET * MAIN_P)
PROC_WL = {"dataset": "cifar10", "model": "cnn", "width": 32, "n_train": 8192, "n_test": 512,
           "lr": 0.05}
# the [reference] process case: tests/test_runtime.py's workload
PROC_REF_WL = {"dataset": "cifar10", "model": "mlp", "width": 1, "n_train": 256,
               "n_test": 128, "lr": 0.05}
REFERENCE_CASES = (  # (label, engine knobs, "whole" run or share-step "replay")
    ("full", dict(sharing="full"), "whole"),
    ("faults-sparse", dict(participation=0.9, faults=dict(CHURN_FAULTS, crashes=((5, 0, 1),))),
     "whole"),
    ("faults-dense", dict(mixing="dense", faults=dict(msg_loss=0.3, seed=2)), "whole"),
    ("secure-faults", dict(SECURE_CFG, faults=dict(latency_spike_prob=0.2, corrupt_prob=0.2,
                                                   crashes=((5, 1, 2),), seed=3)), "whole"),
    ("churn-topk", dict(sharing="topk", budget=0.1, payload_quant=True, participation=0.7),
     "replay"),
    ("churn-choco", dict(sharing="choco", budget=0.1, participation=0.7), "replay"),
    ("churn-randomk", dict(sharing="randomk", budget=0.1, participation=0.7), "whole"),
    ("churn-quant", dict(sharing="quant", participation=0.7), "replay"),
    ("secure", SECURE_CFG, "whole"),
    ("topk", dict(sharing="topk", budget=0.1, payload_quant=True), "replay"),
    ("choco", dict(sharing="choco", budget=0.1), "replay"),
    ("dynamic", dict(topology="dynamic"), "whole"),
    ("randomk", dict(sharing="randomk", budget=0.1), "whole"),
    ("quant", dict(sharing="quant"), "replay"),
    ("momentum", dict(optimizer=("momentum", 0.05, dict(nesterov=True))), "whole"),
    ("adamw", dict(optimizer=("adamw", 0.01, dict(eps=1e-3))), "whole"),
    ("local", dict(semantics="local", **SCHED_CFG), "whole"),
    ("async", dict(semantics="async", **SCHED_CFG), "whole"),
    ("async-pairwise", dict(semantics="async", async_gossip="pairwise", participation=0.9,
                            **SCHED_CFG), "whole"),
    ("async-faults", dict(semantics="async", participation=0.9,
                          faults=dict(CHURN_FAULTS, crashes=((5, 0, 1),)), **SCHED_CFG), "whole"),
    ("cohort-flat", dict(COHORT_CFG, cohort_capacity=8), "whole"),
    ("cohort-hier", dict(COHORT_CFG, cohort_capacity=8, selection="hier", segment_size=4),
     "whole"),
    ("cohort-hier-int8", dict(COHORT_CFG, cohort_capacity=8, selection="hier", segment_size=4,
                              cold_dtype="int8"), "whole"),
)


def phase_reference():
    """At N=16, width 8, 2 rounds, on the card and on the CPU (plain
    twins, CPU convolutions) from one set of parameters: full sharing,
    full sharing under faults (message loss, spikes, corruption and a crash
    window at participation 0.9; message loss on the dense W), secure
    aggregation under churn with recovery (and with spikes, corruption and
    a crash window), the dynamic overlay, uniform random-k (its indices
    come from keys, not from X, so its run is continuous; also under churn
    at participation 0.7), and Nesterov momentum and AdamW on full sharing
    must agree after the run within 1e-4, with equal bytes and fault
    counters.  TopK (int8) and CHOCO-SGD, both with the histogram
    selector, and quantized sharing with stochastic rounding, each alone
    and under churn: every share step of the card's run, replayed on the
    CPU from the same inputs (the operand, degree and mask it was given)
    and key, must agree within 1e-4, with equal bytes, and leave the down
    rows' state bitwise as it was.  (Across whole runs these are
    discontinuous: a fp32 rounding of local training can move a coordinate
    across the top-k threshold or an int8 code boundary, floor(y + u)'s
    included.  Their whole-run difference is printed.)"""
    import torch
    from repro_torch.core.faults import STAT_KEYS
    from repro_torch.utils.pytree import tree_map

    for label, knobs, mode in REFERENCE_CASES:
        gpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cuda",
                               **knobs)
        init = tree_map(lambda a: a.cpu().clone(), gpu.scheduler.eval_params())
        cpu = main_path_engine(16, 8, 2048, rounds=2, chunk=2, eval_every=1, device="cpu",
                               init_params=init, **knobs)
        if knobs.get("cold_dtype", "fp32") != "fp32":
            # both start from the card's stored rows (a re-encode of the
            # decoded rows could move a scale by an ulp)
            cpu.scheduler._cold_params = to_cpu(gpu.scheduler._cold_params)
        full = mode == "whole"
        if not full:
            hist = {"selector": "hist"} if label.split("-")[-1] in ("topk", "choco") else {}
            rec = Recorder(dataclasses.replace(gpu.sharing, **hist))
            gpu.sharing = gpu.steps.sharing = rec
            cpu.sharing = cpu.steps.sharing = dataclasses.replace(cpu.sharing, **hist)
        gpu.run(log=False)
        cpu.run(log=False)
        diff = float((flat_state(gpu).cpu() - flat_state(cpu)).abs().max())
        print(f"[reference] {label} {knobs}: N=16 width 8, 2 rounds: max |X_gpu - X_cpu| = "
              f"{diff}; bytes gpu={gpu.bytes_sent} cpu={cpu.bytes_sent}; "
              f"sim_time_s gpu={gpu.sim_time_s} cpu={cpu.sim_time_s}", flush=True)
        if gpu.bytes_sent != cpu.bytes_sent or gpu.history[-1].keys() != cpu.history[-1].keys():
            raise AssertionError("bytes_sent or the history keys differ between card and CPU")
        counters = [{k: e.history[-1].get(k) for k in STAT_KEYS} for e in (gpu, cpu)]
        if counters[0] != counters[1] or gpu.scheduler._fault_totals != cpu.scheduler._fault_totals:
            raise AssertionError(f"fault counters differ between card and CPU: {counters}")
        if "semantics" in knobs:
            # the clocks, events, fired counts, overflow and fallbacks
            sm = [sched_metrics(e) for e in (gpu, cpu)]
            print(f"[reference] {label}: {sm[0]}", flush=True)
            ev = [e.scheduler._events.cpu() for e in (gpu, cpu)
                  if hasattr(e.scheduler, "_events")]
            if (sm[0] != sm[1] or gpu.sim_time_s != cpu.sim_time_s
                    or (ev and not torch.equal(*ev))):
                raise AssertionError(f"{label}: scheduler metrics differ between card and "
                                     f"CPU: {sm}, sim_time_s {gpu.sim_time_s} {cpu.sim_time_s}")
        if "faults" in knobs:
            print(f"[reference] {label}: counters {counters[0]}", flush=True)
            if counters[0]["faults_injected"] == 0:
                raise AssertionError(f"{label}: no fault was injected")
        if full and knobs.get("cold_dtype") == "int8":
            # each step re-encodes the fired rows: an fp32 rounding of the
            # card's convolutions moves a value across an int8 rounding
            # boundary now and then, a difference of one code (the row's
            # scale), as TopK's threshold does (see the replay cases)
            d = (flat_state(gpu).cpu() - flat_state(cpu)).abs()
            step = code_steps(gpu)
            over = int((d > 1e-4).sum())
            print(f"[reference] {label}: {over} of {d.numel()} parameters apart by more than "
                  f"1e-4, max |d| / (1e-4 + the row's code step) = "
                  f"{float((d / (1e-4 + step)).max())}", flush=True)
            if not bool((d <= 1e-4 + step).all()):
                raise AssertionError(f"card and CPU disagree by more than one int8 code: {diff}")
            continue
        if full:
            if not diff <= 1e-4:
                raise AssertionError(f"card and CPU disagree: {diff}")
            continue
        strategy = cpu.sharing
        for r, (X, W, state, key, degree, act, X2, state2, nbytes) in enumerate(rec.log):
            # (before the replay, which updates ``state`` in place)
            frozen = act is None or all(torch.equal(state2[k][act == 0], state[k][act == 0])
                                        for k in state2)
            X2c, state2c, nbc = strategy.round(X, W, state, key=key, degree=degree,
                                               **({} if act is None else {"act": act}))
            d = max([float((X2 - X2c).abs().max())]
                    + [float((state2[k] - state2c[k]).abs().max()) for k in state2])
            print(f"[reference] {label} round {r}: share step card vs CPU "
                  f"from the same inputs: max diff {d}"
                  + ("" if act is None else f"; {int((act == 0).sum())} down rows' state "
                     f"unchanged on the card: {frozen}"), flush=True)
            if not d <= 1e-4 or nbc != nbytes or not frozen:
                raise AssertionError(f"share step card and CPU disagree: {d}, {nbytes} vs {nbc}, "
                                     f"down rows frozen: {frozen}")
        if len(rec.log) != 2:
            raise AssertionError(f"{len(rec.log)} share steps recorded, want 2")


STRAGGLER_FLAGS = ["--straggler-factor", "10", "--straggler-frac", "0.1"]


def phase_examples():
    """The study entry points as a user runs them on the card, at
    ``--rounds 4`` (16 nodes, the MLP): ``repro_torch.topologies_dynamic``
    (ring, 5-regular, fully connected, dynamic),
    ``repro_torch.sparsification`` (full, random-k, TopK, CHOCO-SGD at a
    10% budget), ``repro_torch.faults`` (the message-loss sweep, with
    corruption 0.05 and a crash window), ``repro_torch.churn``
    (participation 1.0 to 0.5) and ``repro_torch.fl_vs_dl`` (FedAvg
    against D-PSGD), each with the accuracy and MB/node it returns and the
    kernel launches of its run; the sparse overlays must reach the gather
    merge and the payload strategies the payload merge.  Then
    ``repro_torch.secure_aggregation`` (D-PSGD against secure, the masked
    message and the aggregate; the keyed mask kernel must run) and
    ``repro_torch.processes`` at its defaults (4 workers on the card, one
    killed) and with ``--rejoin`` (the killed worker relaunched and
    re-admitted; the twin asserts it)."""
    import math

    from repro_torch import churn, faults, fl_vs_dl, sparsification, topologies_dynamic

    res = {}
    merge = ("gossip_mix_rows",)
    for name, mod, argv, must in (
            ("topologies_dynamic", topologies_dynamic, [], merge),
            ("sparsification", sparsification, [],
             ("gossip_mix_rows", "payload_mix_rows", "abs_histogram_rows")),
            ("faults", faults, ["--corrupt", "0.05", "--crash", "3:1:3"], merge),
            ("churn", churn, [], merge),
            ("churn", churn, ["--semantics", "local"] + STRAGGLER_FLAGS, merge),
            ("churn", churn, ["--semantics", "async"] + STRAGGLER_FLAGS, merge),
            ("fl_vs_dl", fl_vs_dl, [], merge)):
        reset_launches()
        t = time.time()
        out = mod.main(["--rounds", "4"] + argv)
        launches = read_launches()
        print(f"[examples] {name} --rounds 4 {' '.join(argv)} in {time.time() - t:.2f} s: "
              + ", ".join(f"{k} acc {a:.4f} MB/node {b / 1e6:.3f}" for k, (a, b) in out.items())
              + f"; launches={launches}", flush=True)
        if not all(math.isfinite(a) and b > 0 for a, b in out.values()):
            raise AssertionError(f"{name}: non-finite accuracy or nothing sent: {out}")
        if any(launches[k] == 0 for k in must):
            raise AssertionError(f"{name}: a kernel of {must} was not launched: {launches}")
        res[" ".join([name] + argv[:2])] = out
    from repro_torch import processes, secure_aggregation

    reset_launches()
    t = time.time()
    out = secure_aggregation.main(["--rounds", "4"])
    launches = read_launches()
    print(f"[examples] secure_aggregation --rounds 4 in {time.time() - t:.2f} s: "
          + ", ".join(f"{k} acc {a:.4f} MB/node {b / 1e6:.3f}" for k, (a, b) in out.items())
          + f"; launches={launches}", flush=True)
    if launches["secure_mask_apply_rows_keyed"] == 0 or launches["gossip_mix_rows"] == 0:
        raise AssertionError(f"secure_aggregation: the mask or merge kernel was not launched")
    res["secure_aggregation"] = out
    # the process-backend twin: the kill demo at its defaults, and rejoin
    for argv in ([], ["--rejoin"]):
        t = time.time()
        runner = processes.main(argv)
        print(f"[examples] processes {' '.join(argv)} in {time.time() - t:.2f} s: final acc "
              f"{runner.history[-1]['acc_mean']:.4f}, rows {int(runner.live_rows.sum())}, "
              f"faults_detected {runner.counters['faults_detected']}, rejoined "
              f"{runner.workers_rejoined}, launches {runner.launches}, devices "
              f"{sorted({r['device'] for r in runner.worker_results.values()})}, boot s "
              f"{ {w: r['boot_s'] for w, r in sorted(runner.worker_results.items())} }",
              flush=True)
        if runner.launches["gossip_mix_rows"] == 0:
            raise AssertionError("processes twin: no gather merge in the workers")
        res[" ".join(["processes"] + argv)] = runner.history[-1]["acc_mean"]
    return res


SERVE_B, SERVE_S, SERVE_NEW = 8, 4096, 32   # path A: requests, prompt tokens, new tokens
FWD_B, FWD_S = 4, 2048                      # path B: sequences x tokens (8 chunks of 256)
SWA_SHAPES = (  # (B, S, H, Hkv, D, window, dtype)
    ("prefill", (SERVE_B, SERVE_S, 9, 3, 64, 4096, "bfloat16")),
    ("window cuts", (1, 8192, 9, 3, 64, 4096, "bfloat16")),
    ("fp32", (2, 2048, 9, 3, 64, 1024, "float32")),
    ("ragged", (3, 200, 6, 2, 40, 100, "float32")))
SSD_SHAPES = ((32, 256, 32, 64, 128), (3, 16, 2, 8, 8))  # (G, L, H, P, N)


def swa_bound(b, s, h, hkv, d, window, item):
    """q, k, v read once and out written once (bytes) against 4·D flops per
    in-window (query, key) pair (q·k and p·v), at the bf16 tensor-core rate
    for bf16 inputs and the fp32 rate for fp32; the larger of the two."""
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w   # sum over queries of min(i + 1, window)
    return bound_ms(b * s * (2 * h + 2 * hkv) * d * item, 4 * d * pairs * b * h,
                    BF16_FLOPS if item == 2 else FP32_FLOPS)


def ssd_bound(g, l, h, p, n, products=1, rate=FP32_FLOPS):
    """xdt, B, C and cum read once, y, state and decay written once (fp32
    bytes), against two flops per multiply-add of C·Bᵀ once per chunk cell
    over j <= i, the causal half of scores @ xdt per head and the state
    product per head, each multiply-add taken ``products`` times, at
    ``rate``: the fp32 rate, or the TF32 tensor rate with the kernel's
    three products per multiply-add (3xTF32); the larger of the two."""
    tri = l * (l + 1) // 2
    nbytes = 4 * (2 * g * l * h * p + 2 * g * l * n + g * l * h + g * h * n * p + g * h)
    return bound_ms(nbytes, 2 * products * (g * tri * n + g * h * tri * p + g * h * l * n * p),
                    rate)


def phase_lm_kernels():
    """The two language-model kernels against their twins: the
    sliding-window attention at the SmolLM-135M prefill's shape (8 x 4096,
    9 query over 3 KV heads, head dim 64, window 4096, bf16), where the
    window cuts (S 8192), in fp32 and at a small ragged shape, with
    ``scaled_dot_product_attention`` under the same band mask as its
    yardstick; the SSD chunk step at the Mamba2-370M forward's shape (G 32
    chunk cells, L 256, H 32, P 64, N 128) and at the smoke chunk's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.kernels import swa_attention as swa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for label, (b, s, h, hkv, d, w, dt) in SWA_SHAPES:
        dt = getattr(torch, dt)
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
        k, v = torch.randn((2, b, s, hkv, d), generator=gen, device=dev).to(dt)
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # where the window covers every key, causal attention is the same
        # function, and SDPA may take a flash backend for it
        causal = {"library_is_causal": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)} if w >= s else {}
        rec = check(
            f"swa_attention_gqa {label} B={b} S={s} H={h} Hkv={hkv} D={d} window={w} "
            f"{str(dt).split('.')[-1]} route={swa._route(dt, d)}",
            lambda: swa.swa_attention_gqa(q, k, v, w),
            lambda: swa.swa_attention_gqa_ref(q, k, v, w),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True),
            swa_bound(b, s, h, hkv, d, w, q.element_size()),
            tol=1e-2 if dt == torch.bfloat16 else 1e-4,
            library_covers="scaled_dot_product_attention(enable_gqa) with the band as a boolean "
                           "mask, on (B, H, S, D) views", yardsticks=causal)
        print(f"[kernel] scaled_dot_product_attention backends at {label}: band mask "
              f"{sdpa_backend(rec['library_kernels'])}" + (
                  f", is_causal {sdpa_backend(rec['library_is_causal_kernels'])} "
                  f"({rec['library_is_causal_ms']} ms)" if causal else ""), flush=True)
        out.setdefault("swa_attention_gqa", rec)
        del q, k, v, qt, kt, vt, band
        torch.cuda.empty_cache()
    for g, l, h, p, n in SSD_SHAPES:
        xdt = torch.randn((g, l, h, p), generator=gen, device=dev) * 0.2
        bc, cc = torch.randn((2, g, l, n), generator=gen, device=dev) * 0.4
        cum = -torch.cumsum(torch.rand((g, l, h), generator=gen, device=dev) * 0.5, dim=1)
        rec = check(
            f"ssd_chunk G={g} L={l} H={h} P={p} N={n}",
            lambda: ssd.ssd_chunk(xdt, bc, cc, cum), lambda: ssd.ssd_chunk_ref(xdt, bc, cc, cum),
            None, ssd_bound(g, l, h, p, n), tol=1e-4,
            library_covers="none: no one PyTorch call computes the masked, decay-weighted "
                           "chunk product and the chunk state")
        rec["bound_tf32x3_ms"], rec["bound_tf32x3_by"] = ssd_bound(g, l, h, p, n, 3, TF32_FLOPS)
        print(f"[kernel] ssd_chunk G={g} L={l} H={h} P={p} N={n}: bound {rec['bound_ms']} ms "
              f"at the fp32 rate ({rec['bound_by']}), {rec['bound_tf32x3_ms']} ms at the TF32 "
              f"tensor rate with 3 products per multiply-add ({rec['bound_tf32x3_by']})",
              flush=True)
        out.setdefault("ssd_chunk", rec)
    torch.cuda.empty_cache()
    return out


def phase_serve():
    """Path A: SmolLM-135M at its published config (bf16, window 4096) with
    the sliding-window kernel, through ``ServingEngine.generate``: 8
    requests of 4096-token prompts and 32 greedy new tokens (the KV ring
    buffer wraps at position 4096).  The launches of one generate are read
    with every count set to 0 just before; then the same requests split at
    the prefill give the prefill's time (to first token) and launches and
    the decode's time per token and launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.utils.pytree import tree_size

    dev = torch.device("cuda")
    cfg = get_config("smollm-135m").replace(attn_impl="pallas_swa")
    t = time.time()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = tree_size(params)
    eng = ServingEngine(cfg, ServeConfig(batch=SERVE_B, max_len=SERVE_S + SERVE_NEW), params, dev)
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_B, SERVE_S)), device=dev)
    eng.generate(prompts, max_new=2)  # warm-up
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
          f"parameters ({cfg.dtype}), window {cfg.sliding_window}; set up and warmed in "
          f"{time.time() - t:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ids = eng.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] generate: launches={launches}", flush=True)
    want = {**{k: 0 for k in launches}, "swa_attention_gqa": cfg.n_layers}
    if launches != want:
        raise AssertionError(f"serve path launches {launches}, want {want}")

    reset_launches()
    t0 = time.time()
    logits, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    t1 = time.time()
    pre = read_launches()
    reset_launches()
    ids2 = eng.decode(logits, cache, SERVE_S, SERVE_NEW)
    torch.cuda.synchronize()
    t2 = time.time()
    dec = read_launches()
    if pre["swa_attention_gqa"] != cfg.n_layers or any(dec.values()):
        raise AssertionError(f"prefill launches {pre}, decode launches {dec}")
    if not (tuple(ids.shape) == (SERVE_B, SERVE_NEW) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab and bool(torch.isfinite(logits).all())):
        raise AssertionError("serve path: ids out of range or non-finite logits")
    profile_call("one serve prefill (8 x 4096 tokens)", lambda: eng.prefill(prompts))
    profile_call("one serve decode step", lambda: eng.decode(logits, cache, SERVE_S + SERVE_NEW, 1))
    prefill_s, decode_s = t1 - t0, t2 - t1
    flops = 2 * n_params * SERVE_B * SERVE_S
    print(f"[serve] prefill (time to first token) {prefill_s * 1e3} ms for {SERVE_B}x{SERVE_S} "
          f"tokens: model FLOPs 2*N*tokens = {flops:.6g}, {flops / prefill_s / BF16_FLOPS:.4f} "
          f"of the bf16 peak; decode {decode_s * 1e3 / SERVE_NEW} ms per step, "
          f"{SERVE_B * SERVE_NEW / decode_s} tokens/s; peak max_memory_allocated={peak} B; "
          f"split run ids equal to generate's: {bool(torch.equal(ids, ids2))}", flush=True)
    return launches


def phase_serve_bf16_reference():
    """The bf16 serve path against the fp32 route on the card: SmolLM-135M
    at its published width and depth (30 layers, window 4096) on [serve]'s
    random weights (seed 0), 2 prompts of 4096 tokens, through three routes:
    (a) bf16 with the tensor-core kernel (``swa_mma_kernel``, P rounded to
    bf16 before P·V), (b) bf16 with plain torch attention, (c) fp32 with
    the SIMT kernel (held against the CPU at 1e-4 by [lm-reference]), on
    the bf16 weights cast to fp32.  For (a) and (b): max |logits - fp32
    logits| over the prefill logits against the fp32 logits' scale, the
    share of greedy first-token ids equal to (c)'s, and the same readings
    over every position of a forward.  Fails when (a)'s error exceeds
    5e-2 x scale, or 2 x (b)'s error + 1e-3 x scale (the kernel's P
    rounding costing more than bf16 itself)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import forward, init_params
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("smollm-135m").replace(attn_impl="pallas_swa")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, SERVE_S)), device=dev)
    routes = (("bf16 kernel", cfg, params, "mma"),
              ("bf16 naive", cfg.replace(attn_impl="naive"), params, None),
              ("fp32 kernel", cfg.replace(dtype="float32"),
               tree_map(lambda a: a.float(), params), "simt"))
    res = {}
    with torch.no_grad():
        for name, c, p, route in routes:
            eng = ServingEngine(c, ServeConfig(batch=2, max_len=SERVE_S + 1), p, dev)
            reset_launches()
            logits, _ = eng.prefill(prompts)
            launched = read_launches()["swa_attention_gqa"]
            full = forward(p, c, {"tokens": prompts})[0]
            torch.cuda.synchronize()
            want = c.n_layers if route else 0
            if launched != want:
                raise AssertionError(f"[serve-bf16-reference] {name}: {launched} attention "
                                     f"kernel launches in the prefill, want {want}")
            res[name] = (logits[:, -1].float(), full.float().argmax(-1), full)
            del eng
    ref_logits, ref_ids, ref_full = res.pop("fp32 kernel")
    scale = float(ref_logits.abs().max())
    full_scale = float(ref_full.float().abs().max())
    err = {}
    for name, (lg, ids, full) in res.items():
        err[name] = float((lg - ref_logits).abs().max())
        first = float((lg.argmax(-1) == ref_logits.argmax(-1)).float().mean())
        full_err = max(float((full[b].float() - ref_full[b]).abs().max()) for b in range(2))
        pos = float((ids == ref_ids).float().mean())
        print(f"[serve-bf16-reference] {name} vs fp32 kernel ({cfg.n_layers} layers, 2 x "
              f"{SERVE_S} tokens): prefill logits max |d| = {err[name]} (fp32 scale {scale}, "
              f"{err[name] / scale} of it); greedy first-token ids equal: {first}; every "
              f"position of a forward: max |d| = {full_err} (scale {full_scale}), argmax "
              f"equal at {pos}", flush=True)
    a, b = err["bf16 kernel"], err["bf16 naive"]
    ok = a <= 5e-2 * scale and a <= 2 * b + 1e-3 * scale
    print(f"[serve-bf16-reference] bound: kernel {a} <= 5e-2 x scale = {5e-2 * scale} and "
          f"<= 2 x naive + 1e-3 x scale = {2 * b + 1e-3 * scale}: {ok}", flush=True)
    if not ok:
        raise AssertionError("bf16 serve path: the kernel route is further from the fp32 "
                             "route than bf16 alone allows")


def phase_forward():
    """Path B: the Mamba2-370M teacher-forced forward and loss at its
    published config (bf16, chunk 256) with the SSD chunk kernel, on 4 x
    2048 tokens through ``loss_fn``, with the launch counts read around one
    call; then the forward's time."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import forward, init_params, loss_fn
    from repro_torch.utils.pytree import tree_size

    dev = torch.device("cuda")
    cfg = get_config("mamba2-370m").replace(ssm_impl="pallas")
    t = time.time()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    n_params = tree_size(params)
    toks = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (FWD_B, FWD_S + 1)), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn(params, cfg, batch)  # warm-up
    torch.cuda.synchronize()
    print(f"[forward] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
          f"parameters ({cfg.dtype}), chunk {cfg.ssm_chunk}; set up and warmed in "
          f"{time.time() - t:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = loss_fn(params, cfg, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[forward] loss_fn: launches={launches}; loss={float(loss)}", flush=True)
    want = {**{k: 0 for k in launches}, "ssd_chunk": cfg.n_layers}
    if launches != want:
        raise AssertionError(f"forward path launches {launches}, want {want}")
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    fwd_ms = time_ms(lambda: forward(params, cfg, batch), iters=3, warmup=0)
    profile_call("one forward (4 x 2048 tokens)", lambda: forward(params, cfg, batch))
    tokens = FWD_B * FWD_S
    flops = 2 * n_params * tokens
    print(f"[forward] forward {fwd_ms} ms for {FWD_B}x{FWD_S} tokens: "
          f"{tokens / fwd_ms * 1e3} tokens/s; model FLOPs 2*N*tokens = {flops:.6g}, "
          f"{flops / (fwd_ms * 1e-3) / BF16_FLOPS:.4f} of the bf16 peak; "
          f"peak max_memory_allocated={peak} B (loss_fn)", flush=True)
    return launches


def phase_lm_reference():
    """Both models in fp32 at full width and 2 layers, from one set of
    parameters on the card and on the CPU (plain twins): SmolLM-135M served
    with a 256-token window (the kernel route; a prefill may not outgrow the
    window's ring buffer, so the window is the prompt's length and the ring
    wraps in decode) on 2 prompts of 256 tokens, prefill logits within 1e-4
    and 8 greedy ids equal; Mamba2-370M's
    forward on 2 x 512 tokens, logits within 1e-3 (fp32 SSD sums in other
    orders, 2 layers of width 2048); and on the card Mamba2's forward
    against its token-by-token decode at every position, within 2e-3 as
    ``tests/test_decode_consistency.py`` holds the reference.  fp32 matrix
    products stay full fp32 (no TF32)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import decode_step, forward, init_cache, init_params
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = get_config("smollm-135m").replace(n_layers=2, dtype="float32", sliding_window=256,
                                            attn_impl="pallas_swa")
    params = init_params(cfg, torch.Generator().manual_seed(2))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 256))
    res = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        eng = ServingEngine(cfg, ServeConfig(batch=2, max_len=256 + 8),
                            tree_map(lambda a: a.to(d), params), d)
        reset_launches()
        logits, cache = eng.prefill(torch.as_tensor(prompts, device=d))
        ids = eng.decode(logits, cache, 256, 8)
        res[where] = (logits.cpu(), ids.cpu(), read_launches()["swa_attention_gqa"])
    diff = float((res["card"][0] - res["cpu"][0]).abs().max())
    print(f"[lm-reference] smollm-135m fp32, 2 layers, window 256, 2x256 prompts: prefill "
          f"logits max |card - cpu| = {diff} (scale {float(res['cpu'][0].abs().max())}); "
          f"greedy ids equal: {bool(torch.equal(res['card'][1], res['cpu'][1]))}; card kernel "
          f"launches {res['card'][2]}", flush=True)
    if not (diff <= 1e-4 and torch.equal(res["card"][1], res["cpu"][1])
            and res["card"][2] == cfg.n_layers):
        raise AssertionError("smollm-135m: card and CPU disagree, or the kernel was not taken")

    cfg = get_config("mamba2-370m").replace(n_layers=2, dtype="float32", ssm_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(3))
    gparams = tree_map(lambda a: a.to(dev), params)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 512)))
    reset_launches()
    lg = forward(gparams, cfg, {"tokens": toks.to(dev)})[0]
    launched = read_launches()["ssd_chunk"]
    lc = forward(params, cfg, {"tokens": toks})[0]
    diff = float((lg.cpu() - lc).abs().max())
    cache = init_cache(cfg, 2, 512, device=dev)
    worst = 0.0
    for t in range(512):
        step, cache = decode_step(gparams, cfg, cache, toks[:, t:t + 1].to(dev), t)
        err = (step[:, 0] - lg[:, t]).abs() - 2e-3 * lg[:, t].abs()
        worst = max(worst, float(err.max()))
    print(f"[lm-reference] mamba2-370m fp32, 2 layers, 2x512 tokens: forward logits max "
          f"|card - cpu| = {diff} (scale {float(lc.abs().max())}), card kernel launches "
          f"{launched}; decode vs forward on the card: max(|d - f| - 2e-3 |f|) = {worst}",
          flush=True)
    if not (diff <= 1e-3 and worst <= 2e-3 and launched == cfg.n_layers):
        raise AssertionError("mamba2-370m: card and CPU, or decode and forward, disagree")


POP_N, POP_C, MILLION_N = 100_000, 8192, 1_000_000
POP_SHAPE, POP_HIDDEN, POP_SPREAD = (4, 4, 1), 16, 15.0  # benchmarks/bench_population.py


def flat_state(eng):
    """The (N, P) fp32 parameters (decoded from compressed cold rows)."""
    import torch
    from repro_torch.utils.pytree import tree_leaves

    if eng.X is not None:
        return eng.X
    n = eng.dl.n_nodes
    return torch.cat([l.reshape(n, -1) for l in tree_leaves(eng.scheduler.eval_params())], 1)


def to_cpu(tree):
    """A stored cold tree (QuantRows leaves included) copied to the CPU."""
    from repro_torch.core import compression as cc

    return cc.cold_tree_map(lambda a: cc.QuantRows(a.q.cpu(), a.s.cpu())
                            if isinstance(a, cc.QuantRows) else a.cpu(), tree)


def code_steps(eng):
    """(N, P) each parameter's int8 code step: its row's scale in its leaf."""
    import torch
    from repro_torch.utils.pytree import tree_leaves

    n = eng.dl.n_nodes
    return torch.cat([q.s.cpu()[:, None].expand(n, q.q[0].numel())
                      for q in tree_leaves(eng.scheduler._cold_params)], 1)


def sched_metrics(eng):
    """The scheduler's clock and event metrics of the last record."""
    h = eng.history[-1]
    return {k: h[k] for k in h if k.startswith(("vclock", "events", "staleness", "cohort",
                                                "selection"))}


def phase_local_path():
    """Neighbourhood-barrier clocks on the quickstart configuration with
    stragglers: one gather-merge launch per round; the parameters equal a
    synchronous engine's of the same configuration bitwise after the same
    rounds, with the same bytes, and the largest clock is at most the sync
    barrier's time."""
    import torch

    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                           semantics="local", **SCHED_CFG)
    print(f"[local] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params}",
          flush=True)
    _, launches = drive_path("local", eng, {"gossip_mix_rows": eng.dl.rounds})
    sync = main_path_engine(MAIN_N, 32, 32768, rounds=8, chunk=4, eval_every=4, device=None,
                            **SCHED_CFG)
    sync.run(log=False)
    same = bool(torch.equal(eng.X, sync.X))
    print(f"[local] {sched_metrics(eng)} sim_time_s={eng.sim_time_s} (sync barrier "
          f"{sync.sim_time_s}); X equal to the sync engine's bitwise: {same}; bytes "
          f"{eng.bytes_sent} (sync {sync.bytes_sent})", flush=True)
    if not same or eng.bytes_sent != sync.bytes_sent:
        raise AssertionError("local semantics parted from the sync trajectory")
    if not eng.sim_time_s <= sync.sim_time_s:
        raise AssertionError("the local clock passed the sync barrier's time")
    del sync
    return launches, eng


def phase_async_path(pairwise=False):
    """Event-driven gossip on the quickstart model with stragglers, one
    local step per event and a zero time slice (``examples/churn.py``'s
    async setting; ``benchmarks/bench_engine.py`` part 5): neighbourhood
    gossip makes one gather-merge launch per cohort (16 cohorts); pairwise
    gossip (participation 0.9, 8 cohorts) averages with one partner by
    elementwise torch ops and launches no kernel."""
    path = "async-pairwise" if pairwise else "async"
    knobs = dict(semantics="async", **SCHED_CFG)
    if pairwise:
        knobs.update(async_gossip="pairwise", participation=0.9)
    cohorts = 8 if pairwise else 16
    t = time.time()
    eng = main_path_engine(MAIN_N, 32, 32768, rounds=cohorts, chunk=4, eval_every=cohorts // 2,
                           device=None, local_steps=1, **knobs)
    print(f"[{path}] engine built in {time.time() - t:.2f} s: N={MAIN_N} P={eng.n_params}",
          flush=True)
    hist, launches = drive_path(path, eng, {} if pairwise else {"gossip_mix_rows": cohorts})
    first, last = hist[0], hist[-1]
    dt = last["wall_s"] - first["wall_s"]
    m = sched_metrics(eng)
    print(f"[{path}] cohorts/s {(last['round'] - first['round']) / dt:.4f}; events/s "
          f"{(last['events_total'] - first['events_total']) / dt:.2f}; fired per cohort "
          f"{m['events_total'] / cohorts:.2f}; {m}; sim_time_s={eng.sim_time_s}", flush=True)
    if not 0 < m["events_total"] <= MAIN_N * cohorts or m["events_min"] == m["events_max"]:
        raise AssertionError(f"{path}: the stragglers fire as often as the rest: {m}")
    return launches, eng


def population_engine(n, c, *, device=None, selection="flat", cold="fp32", spread=0.0,
                      slice_s=0.0, chunk=8, batch=8, seed=0):
    """``benchmarks/bench_population.py``'s engine on the port: N nodes of a
    (4·4·1 -> 16 -> 2) tanh MLP (P = 306), a 4-regular overlay, async
    neighbourhood gossip with cohort capacity ``c`` (0: the dense path),
    ``batch_keying="node"``, 1 ms events (``spread``: x U(1, 1+spread)),
    no network model.  The weights are drawn in bulk from one seeded
    generator on the card."""
    import numpy as np
    import torch
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.core.engine import resolve_device
    from repro_torch.data import NodeBatcher
    from repro_torch.optim import make_optimizer

    rng = np.random.default_rng(seed)
    n_train = max(n, 256)
    x = rng.normal(size=(n_train, *POP_SHAPE)).astype(np.float32)
    y = rng.integers(0, 2, size=(n_train,)).astype(np.int32)
    parts = np.array_split(np.arange(n_train), n)
    dl = DLConfig(n_nodes=n, topology="regular", degree=4, sharing="full", semantics="async",
                  async_gossip="neighborhood", async_slice_s=slice_s, chunk_rounds=chunk,
                  eval_every=10_000, batch_size=batch, compute_time_s=1e-3, cohort_capacity=c,
                  seed=seed, batch_keying="node", selection=selection, cold_dtype=cold,
                  compute_spread=spread)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = int(np.prod(POP_SHAPE))
    init = {"w1": torch.randn((n, feat, POP_HIDDEN), generator=g, device=dev) / feat ** 0.5,
            "b1": torch.zeros((n, POP_HIDDEN), device=dev),
            "w2": torch.randn((n, POP_HIDDEN, 2), generator=g, device=dev) / POP_HIDDEN ** 0.5,
            "b2": torch.zeros((n, 2), device=dev)}

    def logits(p, xb):
        h = torch.tanh(xb.reshape(xb.shape[0], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def loss(p, xb, yb):
        return -torch.log_softmax(logits(p, xb), -1).gather(1, yb[:, None]).mean()

    def acc(p, xb, yb):
        return (logits(p, xb).argmax(-1) == yb).float().mean()

    return RoundEngine(dl, None, loss, acc, make_optimizer("sgd", 0.05),
                       NodeBatcher(x, y, parts, batch, seed=seed), init_params=init,
                       device=device)


def slice_for(n, c, fill=0.8):
    """bench_population's cohort window for a steady occupancy of
    ~fill·C under the continuous spread."""
    import numpy as np

    return fill * c / (n * np.log1p(POP_SPREAD) / (1e-3 * POP_SPREAD))


def drive_cohort_path(path, eng, steps, want):
    """``steps`` event steps in spans of the engine's chunk after one
    warm-up span, every launch count set to 0 just before and read just
    after and held to ``want`` (per step); events/s over the timed steps,
    the scheduler's metrics, ``memory_model()`` and the card's allocated
    bytes against the analytic total (hot + cold + the dataset); then one
    more span under the profiler."""
    import torch

    sched, chunk = eng.scheduler, eng.chunk
    sched.run_span(0, chunk)
    torch.cuda.synchronize()
    reset_launches()
    fired0, t = sched._fired_total, time.perf_counter()
    for s in range(chunk, chunk + steps, chunk):
        sched.run_span(s, chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = read_launches()
    print(f"[{path}] launches={launches}", flush=True)
    want = {**{k: 0 for k in launches}, **{k: v * steps for k, v in want.items()}}
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, want {want}")
    finite = all(bool(torch.isfinite(l).all()) for l in sched.eval_params().values())
    if not finite:  # (the decoded copy is freed before the bytes are read)
        raise AssertionError(f"{path}: non-finite parameters")
    m = sched.extra_metrics()
    mm = sched.memory_model()
    data = sum(t.numel() * t.element_size()
               for t in (eng._dev_x, eng._dev_y, eng._dev_lens, eng._dev_parts_pad))
    analytic = mm["hot"]["total"] + mm["cold"]["total"] + data
    live = torch.cuda.memory_allocated()
    rate = (sched._fired_total - fired0) / dt
    print(f"[{path}] N={eng.dl.n_nodes} C={sched._cohort_c} P={eng.n_params} "
          f"selection={sched._selection} cold={sched._cold}: {steps} steps in {dt:.3f} s, "
          f"{steps / dt:.2f} steps/s, events/s {rate:.1f}; {m}; memory_model hot "
          f"{mm['hot']['total']} B cold {mm['cold']['total']} B (fp32 cold "
          f"{mm['cold']['total_fp32']} B), dataset {data} B; memory_allocated {live} B vs "
          f"analytic {analytic} B (ratio {live / analytic:.3f})", flush=True)
    if m["events_total"] <= 0 or m["cohort_occupancy_mean"] <= 0:
        raise AssertionError(f"{path}: no event fired")
    profile_call(f"one {path} span of {chunk} steps",
                 lambda: sched.run_span(chunk + steps, chunk))
    return launches, {"events_per_s": rate, "metrics": m, "memory_model": mm,
                      "memory_allocated": live, "analytic_bytes": analytic}


def phase_population():
    """bench_population's population stage on the port: N=100,000, C=8192,
    homogeneous 1 ms events, a zero slice (a step fires up to C of the
    tied nodes), fp32 cold rows, flat selection, 32 steps in spans of 8: one gather-merge
    launch per step (the cohort merge over rows [cids | nbr])."""
    t = time.time()
    eng = population_engine(POP_N, POP_C)
    print(f"[population] engine built in {time.time() - t:.2f} s", flush=True)
    launches, _ = drive_cohort_path("population", eng, 32, {"gossip_mix_rows": 1})
    return launches, eng


def phase_million():
    """bench_population's million stage on the port: N=1,000,000, C=8192,
    segment-minimum selection, int8 cold rows, the continuous compute
    spread and its slice: per step one gather-merge launch, one quantize
    launch per parameter leaf at the scatter and two dequantize launches
    per leaf at the gathers (the hot rows, and the merge's rows).  The
    int8 cold bytes are at most 0.3 of fp32's, and the hierarchy prunes on
    some step."""
    t = time.time()
    eng = population_engine(MILLION_N, POP_C, selection="hier", cold="int8",
                            spread=POP_SPREAD, slice_s=slice_for(MILLION_N, POP_C))
    print(f"[million] engine built in {time.time() - t:.2f} s", flush=True)
    leaves = 4
    launches, rec = drive_cohort_path("million", eng, 32, {
        "gossip_mix_rows": 1, "quantize": leaves, "dequantize": 2 * leaves})
    mm, m = rec["memory_model"], rec["metrics"]
    ratio = mm["cold"]["total"] / mm["cold"]["total_fp32"]
    print(f"[million] int8 cold bytes / fp32 cold bytes = {ratio:.4f}; selection fallbacks "
          f"{m['selection_fallback_total']} of {32 + eng.chunk} steps", flush=True)
    if ratio > 0.3 or m["selection_fallback_total"] >= 32 + eng.chunk:
        raise AssertionError("million: cold bytes over 0.3 of fp32, or the hierarchy never pruned")
    return launches, eng


def phase_cohort_oracles():
    """The reference's oracles on the card: hierarchical selection picks
    the flat selection's cohorts bitwise (bench_population's
    check_selection_oracle: N=4096, C=256, the spread clock, 24 steps), and
    the cohort path at C = N equals the dense async path bitwise (N=1024,
    8 steps)."""
    import torch

    sl = slice_for(4096, 256)
    runs = {}
    for sel in ("flat", "hier"):
        e = population_engine(4096, 256, selection=sel, spread=POP_SPREAD, slice_s=sl, batch=4)
        for s in range(0, 24, e.chunk):
            e.scheduler.run_span(s, e.chunk)
        runs[sel] = e
    f, h = runs["flat"], runs["hier"]
    same = bool(torch.equal(f.X, h.X)) and bool(torch.equal(f.scheduler._events,
                                                          h.scheduler._events))
    fb = h.scheduler.extra_metrics()["selection_fallback_total"]
    print(f"[cohort-oracles] hier == flat bitwise over 24 steps at N=4096 C=256: {same} "
          f"(fallbacks {fb}/24)", flush=True)
    if not same or fb >= 24:
        raise AssertionError("hier selection parted from flat, or never pruned")
    runs = {}
    for c in (0, 1024):
        e = population_engine(1024, c, chunk=4)
        for s in range(0, 8, 4):
            e.scheduler.run_span(s, 4)
        runs[c] = e
    d, c = runs[0], runs[1024]
    same = (bool(torch.equal(d.X, c.X)) and bool(torch.equal(d.scheduler._events,
                                                              c.scheduler._events))
            and d.bytes_sent == c.bytes_sent and d.sim_time_s == c.sim_time_s)
    print(f"[cohort-oracles] cohort C=N == dense bitwise at N=1024 over 8 steps: {same}",
          flush=True)
    if not same:
        raise AssertionError("the cohort path at C=N parted from the dense path")


def phase_scheduler_kernels():
    """The kernels at the new callers' shapes: the cohort merge (C=8192
    rows [cids | nbr] of the N=100,000 population, K=5, P=306), and the
    int8 cold-row codec at a cohort's largest leaf (8192 x 256) and at the
    merge's decode of C·(1+D) rows."""
    import torch
    from repro_torch.core.topology import SparseTopology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    p, k = 306, 5
    X = torch.randn((POP_N, p), generator=gen, device=dev)
    topo = SparseTopology.regular_circulant(POP_N, 4).to(dev)
    cids = torch.sort(torch.randperm(POP_N, generator=gen, device=dev)[:POP_C]).values
    rows = torch.cat([cids[:, None], topo.nbr[cids].long()], 1).to(torch.int32).contiguous()
    w = torch.cat([topo.w_self[cids, None], topo.w[cids]], 1).contiguous()
    out = {"cohort_rows": check(
        f"gossip_mix_rows fp32 cohort merge C={POP_C} K={k} P={p} over N={POP_N} rows",
        lambda: gm.gossip_mix_rows(X, rows, w), lambda: gm.gossip_mix_rows_ref(X, rows, w),
        None, merge_bound_ms(POP_C, k, p, 4, POP_C * k), tol=1e-5)}
    leaf = X[:POP_C, :256].contiguous()
    out["cold_rows"] = check(f"quantize cold rows {POP_C} x 256 (a cohort's w1 leaf)",
                             lambda: q.quantize(leaf), lambda: q.quantize_ref(leaf), None,
                             codec_bound(POP_C, 256, False))
    codes, scale = q.quantize(X[:POP_C * k, :256].contiguous())
    out["cold_decode"] = check(
        f"dequantize cold rows {POP_C * k} x 256 (the merge's decode)",
        lambda: q.dequantize(codes, scale), lambda: q.dequantize_ref(codes, scale), None,
        codec_bound(POP_C * k, 256, False))
    del X, codes, scale
    torch.cuda.empty_cache()
    return out


def phase_process_kernels():
    """The kernels at a process worker's shapes (the [processes] phase's
    worker 1 of 4 over N=256, P=579,594): the gather merge of the own
    64-row block over the 256-row view (K=6), the payload merge of the
    own rows from the 256 payload rows of random-k at 10% (k=57,959, the
    int8 wire's self slot, S=6), and the codec over the own (64, k)
    payload."""
    import torch
    from repro_torch.core.topology import SparseTopology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import scatter_gossip as sg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    n, b, p, k = PROC_N, PROC_B, MAIN_P, PROC_KP
    lo, hi = b, 2 * b
    rows, w = SparseTopology.regular_circulant(n, MAIN_DEG).to(dev).merge_tables()
    rows, w = rows[lo:hi].contiguous(), w[lo:hi].contiguous()
    X = torch.randn((n, p), generator=gen, device=dev)
    read = int(torch.unique(rows).numel())
    out = {"gossip_mix_rows": check(
        f"gossip_mix_rows fp32 worker block B={b} of N={n} K={rows.shape[1]} P={p}",
        lambda: gm.gossip_mix_rows(X, rows, w), lambda: gm.gossip_mix_rows_ref(X, rows, w),
        None, merge_bound_ms(b, rows.shape[1], p, 4, read), tol=1e-5)}
    idx = torch.sort(torch.argsort(torch.rand((n, p), generator=gen, device=dev), 1)[:, :k],
                     1).values.to(torch.int32)
    val = X.gather(1, idx.long())
    own = X[lo:hi]
    out["payload_mix_rows"] = check(
        f"payload_mix_rows int8-wire worker block B={b} of N={n} P={p} S={rows.shape[1]} k={k}",
        lambda: sg.payload_mix_rows(own, idx, val, rows, w, sorted_idx=True),
        lambda: sg.payload_mix_rows_ref(own, idx, val, rows, w), None,
        payload_bound(b, p, read, k, rows.shape[1]), tol=1e-5)
    v = val[lo:hi].contiguous()
    out["quantize"] = check(f"quantize worker payload {b} x {k}", lambda: q.quantize(v),
                            lambda: q.quantize_ref(v), None, codec_bound(b, k, False))
    codes, scale = q.quantize(v)
    out["dequantize"] = check(f"dequantize worker payload {b} x {k}",
                              lambda: q.dequantize(codes, scale),
                              lambda: q.dequantize_ref(codes, scale), None,
                              codec_bound(b, k, False))
    del X, idx, val, v, codes, scale
    torch.cuda.empty_cache()
    return out


def frames_per_round(n, workers, degree):
    """ROWS frames the workers receive per round: the (receiver, sender)
    worker pairs with an edge between their row blocks."""
    import numpy as np
    from repro_torch.core.topology import SparseTopology

    st = SparseTopology.regular_circulant(n, degree)
    owner = np.arange(n) // (n // workers)
    nbr, live = np.asarray(st.nbr), np.asarray(st.w) > 0
    pairs = {(owner[i], owner[j]) for i in range(n) for j in nbr[i][live[i]]
             if owner[i] != owner[j]}
    return len(pairs)


def drive_processes(path, dl, workload, want, **runner_kw):
    """One ``ProcessRunner`` run on the card: every kernel count summed
    over the workers' rounds (warm-up apart) held to ``want`` (the kernels
    not named: 0), each worker on the card, finite parameters; prints the
    round walls (the slowest worker's) against ``localhost_deployment``'s
    round time for the same bytes (``runtime.calibrate``'s measure),
    rounds/s after the first round, bytes per node and the row-sum
    error.  Returns the runner."""
    import numpy as np
    from repro_torch.core.engine import build_graph
    from repro_torch.core.network import localhost_deployment
    from repro_torch.core.topology import SparseTopology
    from repro_torch.runtime import ProcessRunner

    t = time.time()
    r = ProcessRunner(dl, workload, workers=PROC_K, watchdog_s=300.0, join_timeout_s=300.0,
                      **runner_kw)
    hist = r.run(log=True)
    wall = time.time() - t
    devices = {w: res["device"] for w, res in sorted(r.worker_results.items())}
    walls = r.round_wall_s
    if dl.sharing == "randomk":
        k = max(1, int(dl.budget * r.n_params))
        per_edge = k * (4 + (1 if dl.payload_quant else 4)) + (4 if dl.payload_quant else 0)
    else:
        per_edge = r.n_params * 4
    graph = build_graph(dl)
    modeled = localhost_deployment(dl.n_nodes).round_time(graph, per_edge, compute_time_s=0.0)
    rps = (len(walls) - 1) / sum(walls[1:])
    topo = SparseTopology.from_graph(graph)
    row_err = float(np.abs(np.asarray(topo.w_self) + np.asarray(topo.w).sum(1) - 1.0).max())
    print(f"[{path}] N={dl.n_nodes} K={PROC_K} P={r.n_params} {dl.sharing}"
          f"{' int8' if dl.payload_quant else ''}: run {wall:.2f} s (worker boot and warm-up "
          f"included); round walls (slowest worker) {walls} s, median "
          f"{float(np.median(walls))} s, steady median {float(np.median(walls[1:]))} s against "
          f"localhost_deployment round_time {modeled} s for {per_edge} B per edge "
          f"(ratio {float(np.median(walls[1:])) / modeled:.1f}); rounds/s after the first "
          f"round {rps:.4f}; bytes_per_node {r.bytes_sent}; wire {r.wire_dtype}; row-sum error "
          f"{row_err} (reweight {r.reweight_row_err}); devices {devices}; launches {r.launches}; "
          f"warm-up launches "
          f"{ {w: res['warmup_launches'] for w, res in sorted(r.worker_results.items())} }; "
          f"worker boot s (set-up, warm-up, registered) "
          f"{ {w: res['boot_s'] for w, res in sorted(r.worker_results.items())} }; "
          f"acc_mean {[h['acc_mean'] for h in hist]}", flush=True)
    # the round's phases: per phase, the median over rounds of the
    # slowest worker's seconds
    phases = {}
    for ph in ("local", "encode", "send", "gather", "merge"):
        per_round = zip(*[[p[ph] for p in res["round_phases_s"]]
                          for res in r.worker_results.values()])
        phases[ph] = float(np.median([max(v) for v in per_round]))
    print(f"[{path}] round phases, median of the slowest worker (s): {phases}", flush=True)
    want = {**{kname: 0 for kname in r.launches}, **want}
    if r.launches != want:
        raise AssertionError(f"{path}: launches {r.launches}, want {want}")
    if set(devices.values()) != {"cuda"} or len(devices) != PROC_K:
        raise AssertionError(f"{path}: workers not all on the card: {devices}")
    if not np.isfinite(r.final_X).all() or r.counters["faults_detected"]:
        raise AssertionError(f"{path}: non-finite parameters or a detected fault: {r.counters}")
    if len(walls) != dl.rounds or not all(res["completed"] for res in r.worker_results.values()):
        raise AssertionError(f"{path}: {len(walls)} rounds of {dl.rounds}, or a worker stopped")
    return r


def phase_processes():
    """The real-network process backend on the card: K=4 worker processes
    sharing the H100, N=256 nodes in blocks of 64, 5-regular, GN-LeNet at
    width 32, 6 rounds: (a) full sharing, one gather merge per worker per
    round; (b) random-k at 10% with the int8 wire, per worker per round one
    payload merge, one quantize and one dequantize of its own payload plus
    one of each received frame; (c) [reference] at N=16 (the MLP of
    tests/test_runtime.py, 3 rounds) from one set of parameters: the
    process run on the card against the same run on the CPU (equal bytes
    and eval rounds) and against the port's simulator on the card and on
    the CPU, all within 1e-4."""
    import numpy as np
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.runtime import build_workload
    from repro_torch.utils.pytree import tree_map

    base = dict(n_nodes=PROC_N, topology="regular", degree=MAIN_DEG, rounds=PROC_ROUNDS,
                eval_every=3, backend="processes")
    rounds = PROC_ROUNDS
    full = drive_processes("processes", DLConfig(**base), PROC_WL,
                           {"gossip_mix_rows": PROC_K * rounds})
    if full.n_params != MAIN_P:
        raise AssertionError(f"P={full.n_params}, want {MAIN_P}")
    frames = frames_per_round(PROC_N, PROC_K, MAIN_DEG)
    rk = drive_processes(
        "processes-randomk",
        DLConfig(**base, sharing="randomk", budget=PROC_BUDGET, payload_quant=True), PROC_WL,
        {"payload_mix_rows": PROC_K * rounds, "quantize": PROC_K * rounds,
         "dequantize": (PROC_K + frames) * rounds})
    if rk.wire_dtype != "int8" or rk.history[-1]["wire_dtype"] != "int8":
        raise AssertionError(f"random-k int8 wire dtype {rk.wire_dtype}")
    launches = {"processes": full.launches, "processes-randomk": rk.launches}
    timing = {p: {"round_wall_s": r.round_wall_s, "bytes_per_node": r.bytes_sent}
              for p, r in (("processes", full), ("processes-randomk", rk))}
    del full, rk
    release()

    # (c) card against CPU from one set of parameters
    cfg = dict(n_nodes=16, topology="regular", degree=MAIN_DEG, rounds=3, eval_every=2, seed=3)
    f, loss, acc, opt, batcher = build_workload(PROC_REF_WL, DLConfig(**cfg))
    sims = {"cpu": RoundEngine(DLConfig(**cfg), f, loss, acc, opt, batcher, device="cpu")}
    init = tree_map(lambda a: a.clone(), sims["cpu"].params)
    sims["cuda"] = RoundEngine(DLConfig(**cfg), f, loss, acc, opt, batcher, init_params=init,
                               device="cuda")
    X = {d: (e.run(log=False), e.X.cpu().numpy())[1] for d, e in sims.items()}
    from repro_torch.runtime import ProcessRunner

    runs = {}
    for d in ("cuda", "cpu"):
        r = ProcessRunner(DLConfig(**cfg, backend="processes"), PROC_REF_WL, workers=PROC_K,
                          watchdog_s=300.0, join_timeout_s=300.0, device=d, init_params=init)
        r.run(log=False)
        runs[d] = r
    pc, pp = runs["cuda"], runs["cpu"]
    d_cpu = float(np.abs(pc.final_X - pp.final_X).max())
    d_sim = {d: float(np.abs(pc.final_X - x).max()) for d, x in X.items()}
    rounds_eq = [h["round"] for h in pc.history] == [h["round"] for h in pp.history] \
        == [h["round"] for h in sims["cuda"].history]
    bytes_eq = [h["bytes_per_node"] for h in pc.history] == \
        [h["bytes_per_node"] for h in pp.history]
    print(f"[reference] processes N=16 K={PROC_K} 3 rounds: max |X_card - X_cpu| = {d_cpu} "
          f"(process runs); against the simulator on the card {d_sim['cuda']}, on the CPU "
          f"{d_sim['cpu']}; bytes_per_node card {pc.bytes_sent} cpu {pp.bytes_sent} (equal "
          f"per eval: {bytes_eq}); eval rounds equal: {rounds_eq}; card launches {pc.launches}; "
          f"devices {[res['device'] for res in pc.worker_results.values()]} / "
          f"{[res['device'] for res in pp.worker_results.values()]}", flush=True)
    if not (d_cpu <= 1e-4 and max(d_sim.values()) <= 1e-4 and bytes_eq and rounds_eq):
        raise AssertionError("the process run on the card disagrees with the CPU or the "
                             "simulator")
    if pc.launches["gossip_mix_rows"] != PROC_K * 3 or set(pp.launches.values()) != {0}:
        raise AssertionError(f"process reference launches card {pc.launches} cpu {pp.launches}")
    return launches, timing


def release():
    """Free a dropped engine before the next path: an engine and its
    scheduler refer to each other, so only the collector frees them, and a
    path's peak memory would otherwise hold the last path's state too."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build

    t_start = time.time()
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
    launches_main, eng = phase_main_path()
    launches = {"gossip_mix_rows": launches_main["gossip_mix_rows"]}
    phase_profile(eng, "main")
    del eng
    release()
    topk_launches, eng = phase_topk_path()
    phase_profile(eng, "topk")
    time_share_step(eng, "topk")
    del eng
    release()
    int_rate, sms, mhz = int32_rate()
    print(f"[device] {sms} SMs, max SM clock {mhz} MHz: {int_rate:.6g} INT32 ops/s", flush=True)
    checks.update(phase_secure_kernels(int_rate))
    entry_launches, flat_launches = phase_entry_points()
    secure_launches, eng = phase_secure_path()
    phase_profile(eng, "secure")
    time_share_step(eng, "secure")
    del eng
    release()
    sampled = phase_sampled_kernels()
    release()
    by_path = {"main": launches_main, "topk": topk_launches, "secure": secure_launches}
    for path, run in (("dynamic", phase_dynamic_path), ("randomk", phase_randomk_path),
                      ("quant", phase_quant_path)):
        by_path[path], eng = run()
        phase_profile(eng, path)
        if path == "dynamic":
            time_share_step(eng, path)
        else:
            time_sampled_share_step(eng, path)
        del eng
        release()
    # the fault axis: the guard's passes are listed among every kernel of
    # the profiled round (a snapshot copy, isfinite's eq/abs/ne/mul/all,
    # a where) and timed alone
    by_path["faults"], eng = phase_faults_path()
    phase_profile(eng, "faults", top=None)
    time_guard(eng)
    del eng
    release()
    by_path["churn-topk"], eng = phase_churn_topk_path()
    profile_churn_topk_round(eng)
    time_share_step(eng, "churn-topk")
    del eng
    release()
    # the local and async schedulers, and the population-scale cohort path
    for path, run in (("local", phase_local_path), ("async", phase_async_path),
                      ("async-pairwise", lambda: phase_async_path(pairwise=True))):
        by_path[path], eng = run()
        del eng
        release()
    sched_kernels = phase_scheduler_kernels()
    for path, run in (("population", phase_population), ("million", phase_million)):
        by_path[path], eng = run()
        del eng
        release()
    phase_cohort_oracles()
    release()
    proc_kernels = phase_process_kernels()
    proc_launches, _ = phase_processes()
    by_path.update(proc_launches)
    release()
    phase_reference()
    release()
    phase_examples()
    release()
    checks.update(phase_lm_kernels())
    serve_launches = phase_serve()
    release()
    phase_serve_bf16_reference()
    release()
    forward_launches = phase_forward()
    release()
    phase_lm_reference()

    by_path.update({"entry": entry_launches, "serve": serve_launches, "forward": forward_launches})
    checks["gossip_mix_rows"] = checks.pop("main")
    checks["gossip_mix_rows"]["dynamic_table"] = sampled["dynamic_table"]
    checks["payload_mix_rows"]["randk_rows"] = sampled["randk_rows"]
    checks["payload_mix_rows"]["strided_rows"] = sampled["strided_rows"]
    checks["quantize"]["prng_noise"] = sampled["prng_noise"]
    checks["dequantize"]["full_width"] = sampled["full_width"]
    checks["gossip_mix_rows"]["cohort_rows"] = sched_kernels["cohort_rows"]
    checks["quantize"]["cold_rows"] = sched_kernels["cold_rows"]
    checks["dequantize"]["cold_rows"] = sched_kernels["cold_decode"]
    for kernel, rec in proc_kernels.items():
        checks[kernel]["block_rows"] = rec
    launches["swa_attention_gqa"] = serve_launches["swa_attention_gqa"]
    launches["ssd_chunk"] = forward_launches["ssd_chunk"]
    launches.update({k: v for k, v in topk_launches.items()
                     if k in ("abs_histogram_rows", "quantize", "dequantize", "payload_mix_rows")})
    launches["secure_mask_apply_rows_keyed"] = secure_launches["secure_mask_apply_rows_keyed"]
    launches.update({k: entry_launches[k] for k in ("threshold_mask", "secure_mask_apply_rows")})
    launches.update(flat_launches)
    # one entry per TPU kernel (each function that reaches pl.pallas_call);
    # the flat forms are their stacked kernels' wrappers at N = 1
    sources = {
        "gossip_mix_rows": ("gossip_mix.cu", "src/repro/kernels/gossip_mix.py:58"),
        "gossip_mix": ("gossip_mix.cu", "src/repro/kernels/gossip_mix.py:30"),
        "payload_mix_rows": ("scatter_gossip.cu", "src/repro/kernels/scatter_gossip.py:56"),
        "abs_histogram_rows": ("sparsify.cu", "src/repro/kernels/sparsify.py:117"),
        "abs_histogram": ("sparsify.cu", "src/repro/kernels/sparsify.py:44"),
        "quantize": ("quantize.cu", "src/repro/kernels/quantize.py:36"),
        "dequantize": ("quantize.cu", "src/repro/kernels/quantize.py:78"),
        "threshold_mask": ("sparsify.cu", "src/repro/kernels/sparsify.py:76"),
        "secure_mask_apply_rows_keyed": ("secure_mask.cu", "src/repro/kernels/secure_mask.py:161"),
        "secure_mask_apply_rows": ("secure_mask.cu", "src/repro/kernels/secure_mask.py:77"),
        "secure_mask_apply": ("secure_mask.cu", "src/repro/kernels/secure_mask.py:42"),
        "swa_attention_gqa": ("swa_attention.cu", "src/repro/kernels/swa_attention.py:67"),
        "ssd_chunk": ("ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:54"),
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
            **{k: c[k] for k in ("device_ms", "device_other_ms", "device_recorded",
                                 "device_launched")},
            **{k: v for k, v in c.items() if k.startswith("library_") and k != "library_ms"},
            **{k: v for k, v in c.items() if k.startswith("bound_tf32")},
            **{k: v for k, v in c.items() if k.startswith(YARDSTICK_KEYS)},
            **{k: v for k, v in c.items() if k.startswith("device_evicted") or k == "device_l2"},
            **{form: {k: c[form][k] for k in PASS_KEYS if k in c[form]}
               for form in FORMS if form in c},
            # the launches of every path's run that launched this kernel
            "launches_by_path": {path: counts[kernel] for path, counts in by_path.items()
                                 if counts.get(kernel)},
        })
    print(f"[done] all phases passed in {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
