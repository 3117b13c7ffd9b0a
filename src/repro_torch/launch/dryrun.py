"""Dry run of every (architecture x input-shape) on one H100, the port of
the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each step on a 512-device placeholder
TPU mesh and reads XLA's cost and memory analyses.  The port executes the
same step once on the ``meta`` device, so no device memory is allocated,
under three counters:

* ``torch.utils.flop_counter.FlopCounterMode``: the products (mm, bmm,
  convolutions, attention), plus the cost that each hand-written kernel's
  wrapper charges (``kernels/cost.py``) -> ``flops_dev``;
* :class:`ByteCounter`: for every aten op its inputs' and outputs' bytes,
  views moving none, an in-place target written once -> ``hbm_bytes_dev``,
  the eager program's unfused traffic (the counterpart of XLA's ``bytes
  accessed``), plus the kernels' charged bytes;
* :class:`LiveTracker`: the live storages (weak references, one entry per
  storage however many tensors view it) -> ``memory``: argument, output
  and temp bytes (the peak of live bytes above the arguments);

and a :class:`~repro_torch.launch.roofline.CollectiveCounter` (zeros on
one card, except for the sharded mixings below).  The same counters read a real step on the CPU or the card
(:func:`count_step`), so the dry run's predictions can be held against a
measured run.  The step is the reference's: the trainer's
``make_train_step`` over ``plan_nodes``' nodes (``topology`` above 5
nodes, else fully connected), the vmapped last-token prefill, or the
vmapped ``decode_step``, on the logical production mesh of
``launch/mesh.py`` (16 node slots on one card).  Per-device numbers are
the whole program's.

The trainer's sharded mixings (``--mixing shard_map|sparse|quant|
sparse+quant``) run one node per rank: the dry run starts torch's fake
process group of as many ranks as nodes (:func:`node_group`, nothing
moves) and executes rank 0's step, one node, on ``meta``; the collective
counter then reads the c10d operand bytes per device, and the per-device
numbers are rank 0's.  On ``meta`` the 'sparse' modes select their top-k
by the exact sort: the histogram selector's survivors have a count that
depends on the data, which a shape-only run cannot place.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/torch_dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch
from torch.func import vmap
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, supports_shape
from repro_torch.core.mixing import _uniform_circulant_weights, circulant_tables
from repro_torch.kernels import cost
from repro_torch.launch.analytic import fused_hbm_bytes
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, make_production_mesh, n_node_slots
from repro_torch.launch.roofline import CollectiveCounter, Roofline, peak_flops_for
from repro_torch.launch.specs import plan_nodes
from repro_torch.models.api import (
    _MetaGenerator,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    model_flops,
)
from repro_torch.optim import sgd
from repro_torch.training.trainer import (
    SHARDED_MIXINGS,
    TrainConfig,
    make_train_step,
    stack_node_params,
)
from repro_torch.utils.pytree import tree_map

aten = torch.ops.aten
# ops that move no bytes: views (by schema, plus these two) and allocations
_NO_TRAFFIC = {aten._unsafe_view.default, aten._reshape_alias.default,
               aten.empty.memory_format, aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.empty_like.default}
# temporaries an op allocates and frees inside itself, which no counter
# sees, by the op's arguments: logsumexp computes exp(x - max) into one of
# x's size (an H100 run of tools/dryrun_transients.py finds it at the
# loss's logits, 1.65 GB for Mamba2-370M over 4 x 2048 tokens, and no
# other above 1 MiB but the attention softmax's backward, under 40 MB)
_INTERNAL = {aten.logsumexp.default: lambda args: footprint(args[0])}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def footprint(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: its size over
    the dims it does not broadcast (stride 0)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


class ByteCounter(TorchDispatchMode):
    """Unfused traffic: per aten op, each distinct input read once and each
    output written once; views and allocations move nothing, and an
    argument the op writes (in place, or ``out=``) counts once, written."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        schema = func._schema.arguments
        written = {a.name for a in schema if a.alias_info is not None and a.alias_info.is_write}
        seen = set()
        for name, v in [*zip((a.name for a in schema), args), *kwargs.items()]:
            if name in written:
                continue
            for t in _tensors(v):
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += footprint(t)
        outs = {id(t): t for t in _tensors(out)}
        self.bytes += sum(footprint(t) for t in outs.values())
        return out


class LiveTracker(TorchDispatchMode):
    """Live bytes of the storages made by ops inside it: each output
    storage is held by a weak reference (one entry however many tensors
    view it) and counted until it is freed; ``peak`` is the most live at
    once, read after every op that could raise it, and inside the ops of
    ``_INTERNAL`` with their own temporaries."""

    def __init__(self):
        super().__init__()
        self.live = {}      # storage cdata -> (StorageWeakRef, bytes)
        self.live_bytes = 0
        self.peak = 0
        self.skip = set()   # the arguments' storages: not the step's

    def _purge(self):
        for key, (ref, nbytes) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        inside = _INTERNAL.get(func)
        if inside is not None:
            extra = inside(args)
            if self.live_bytes + extra > self.peak:
                self._purge()
                self.peak = max(self.peak, self.live_bytes + extra)
        out = func(*args, **(kwargs or {}))
        grew = False
        for t in _tensors(out):
            s = t.untyped_storage()
            ref = StorageWeakRef(s)
            if ref.cdata in self.skip:
                continue
            old = self.live.get(ref.cdata)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self.live_bytes -= old[1]
            self.live[ref.cdata] = (ref, s.nbytes())
            self.live_bytes += s.nbytes()
            grew = True
        if grew and self.live_bytes > self.peak:
            self._purge()
            self.peak = max(self.peak, self.live_bytes)
        return out


def _storage_bytes(tree, exclude=()) -> int:
    seen = dict()
    for t in _tensors(tree):
        ref = StorageWeakRef(t.untyped_storage())
        if ref.cdata not in exclude:
            seen[ref.cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def count_step(fn, args):
    """Run ``fn(*args)`` once under the counters -> (output, readings):
    ``flops_dev``, ``hbm_bytes_dev`` (each the counted ops' plus the
    kernels' charged work), ``memory`` (argument, output and temp bytes;
    temp the peak of live bytes above the arguments), ``coll`` and
    ``kernels`` (the kernels' charged calls by wrapper, flops and bytes)."""
    arg_keys = {StorageWeakRef(t.untyped_storage()).cdata for t in _tensors(args)}
    flops, nbytes, live, coll = (FlopCounterMode(display=False), ByteCounter(), LiveTracker(),
                                 CollectiveCounter())
    live.skip = arg_keys
    with cost.charging() as tally, flops, coll, nbytes, live:
        out = fn(*args)
    readings = dict(
        flops_dev=float(flops.get_total_flops() + tally.flops),
        hbm_bytes_dev=float(nbytes.bytes + tally.bytes),
        coll=coll.result(),
        memory=dict(
            argument_bytes=_storage_bytes(args),
            output_bytes=_storage_bytes(out, exclude=arg_keys),
            temp_bytes=live.peak,
            generated_code_bytes=None,
        ),
        kernels=dict(calls=dict(tally.calls), flops=tally.flops, bytes=tally.bytes),
    )
    return out, readings


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def sanitize_specs(shapes, specs, mesh):
    """Drop sharding on any dim the mesh axes don't divide (e.g. whisper's
    51865 vocab over a model axis of 16)."""
    sizes = mesh.shape

    def fix(t, spec):
        entries = []
        for dim, entry in zip(t.shape, tuple(spec) + (None,) * (t.dim() - len(spec))):
            if entry is None:
                entries.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            total = 1
            for a in axes:
                total *= sizes[a]
            entries.append(entry if dim % total == 0 else None)
        return tuple(entries)

    return tree_map(fix, shapes, specs)


def _stacked_params(cfg, n_nodes: int, device, seed: int):
    """Node-stacked parameters as views of one flat (N, P) buffer: shapes
    only on ``meta``, else node 0's seeded draw copied to every node."""
    if torch.device(device).type == "meta":
        p = init_params(cfg, _MetaGenerator())
    else:
        p = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    return stack_node_params(tree_map(lambda a: a[None].expand(n_nodes, *a.shape), p))


def _makers(dtype, device, seed: int):
    """(ints(shape, high), floats(shape)): empty ``meta`` tensors, or
    seeded random ones where the device holds data."""
    dev = torch.device(device)
    if dev.type == "meta":
        return ((lambda shape, high: torch.empty(shape, dtype=torch.int32, device=dev)),
                (lambda shape: torch.empty(shape, dtype=dtype, device=dev)))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return ((lambda shape, high: torch.randint(0, high, shape, generator=gen, device=dev,
                                               dtype=torch.int32)),
            (lambda shape: torch.randn(shape, generator=gen, device=dev).to(dtype)))


def _batch(cfg, mode: str, n_nodes: int, B: int, S: int, device, seed: int):
    """The node-stacked batch of ``specs.batch_specs`` (its prefill form
    without labels)."""
    ints, floats = _makers(cfg.tdtype, device, seed)
    if cfg.family == "cnn":
        batch = {"images": floats((n_nodes, B, 32, 32, 3))}
    elif cfg.family == "vlm":
        pos = torch.arange(S, dtype=torch.int32, device=device)
        batch = {"embeddings": floats((n_nodes, B, S, cfg.d_model)),
                 "positions": pos.expand(n_nodes, 3, B, S).contiguous()}
    elif cfg.family == "encdec":
        batch = {"frames": floats((n_nodes, B, cfg.enc_seq, cfg.d_model)),
                 "tokens": ints((n_nodes, B, S), cfg.vocab)}
    else:
        batch = {"tokens": ints((n_nodes, B, S), cfg.vocab)}
    if mode == "train":
        batch["labels"] = ints((n_nodes, B) if cfg.family == "cnn" else (n_nodes, B, S),
                               cfg.vocab)
    return batch


@contextlib.contextmanager
def node_group(n_nodes: int):
    """A fake process group of ``n_nodes`` ranks for this process, rank 0
    (torch's ``fake`` backend on the CPU and ``meta``: collectives return
    at once and move nothing) — the group the sharded mixings run their
    dry-run step in."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("node_group: a process group is already initialized")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0,
                            world_size=n_nodes)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_step(cfg, mode: str, n_nodes: int, B: int, S: int, *, device="meta",
               mixing_impl: str = "roll", topology: str = "regular", budget: float = 0.1,
               seed: int = 0):
    """-> (fn, args): one step of ``mode`` (train, prefill, decode, or
    forward: the loss without its gradient) over ``n_nodes`` stacked nodes
    of batch ``B`` and ``S`` positions (the cache depth for decode),
    with every input on ``device``: shapes only on ``meta``, seeded
    random values elsewhere.  The sharded mixings build rank 0's step of a
    group of ``n_nodes`` ranks (:func:`node_group`), over its one node."""
    if mode == "train":
        opt = sgd(1e-2)
        topo = topology if n_nodes > 5 else "fully"
        tc = TrainConfig(n_nodes=n_nodes, topology=topo, degree=5, mixing_impl=mixing_impl,
                         budget=budget)
        step = make_train_step(cfg, opt, tc)
        if mixing_impl in SHARDED_MIXINGS:
            params = _stacked_params(cfg, 1, device, seed)
            args = (params, opt.init(params), _batch(cfg, mode, 1, B, S, device, seed))
            if topo == "dense":
                return step, args + (torch.full((n_nodes, n_nodes), 1.0 / n_nodes,
                                                device=device),)
            return step, args
        if topo in ("ring", "regular") and mixing_impl == "roll":
            # the merge's tables are made once per (n, degree, device) and
            # cached: set-up, not a step's work
            degree = 2 if topo == "ring" else tc.degree
            circulant_tables(n_nodes, degree, torch.device(device))
            _uniform_circulant_weights(n_nodes, degree, torch.device(device))
        params = _stacked_params(cfg, n_nodes, device, seed)
        args = (params, opt.init(params), _batch(cfg, mode, n_nodes, B, S, device, seed))
        if topo == "dense" or mixing_impl == "dense":
            # the mixing matrix, uniform: the step's fourth argument
            return step, args + (torch.full((n_nodes, n_nodes), 1.0 / n_nodes, device=device),)
        return step, args

    params = _stacked_params(cfg, n_nodes, device, seed)
    if mode == "forward":  # the loss's forward pass (scoring), no gradient
        def score(p, batch):
            return vmap(lambda pn, bn: loss_fn(pn, cfg, bn))(p, batch)

        return score, (params, _batch(cfg, "train", n_nodes, B, S, device, seed))
    if mode == "prefill":
        def prefill(p, batch):
            def one(pn, bn):
                logits, _ = forward(pn, cfg, bn)
                # next-token logits only, copied out so that the full
                # logits die with the pass, as the reference's slice does
                return logits[:, -1, :].clone()

            return vmap(one)(p, batch)

        return prefill, (params, _batch(cfg, mode, n_nodes, B, S, device, seed))

    # decode: one token at the cache's last position
    cache = tree_map(lambda l: l[None].expand(n_nodes, *l.shape).contiguous(),
                     init_cache(cfg, B, S, device=torch.device(device)))
    toks = _makers(cfg.tdtype, device, seed)[0]((n_nodes, B, 1), cfg.vocab)

    def serve(p, c, t):
        return vmap(lambda pn, cn, tn: decode_step(pn, cfg, cn, tn, S - 1))(p, c, t)

    return serve, (params, cache, toks)


def build(arch: str, shape_name: str, multi_pod: bool = False, mixing_impl: str = "roll",
          topology: str = "regular", overrides: Optional[dict] = None, device="meta"):
    """-> (fn, args, meta): the reference's step for (arch, input shape)
    on the logical production mesh, inputs on ``device``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    ov = dict(overrides or {})
    gossip_budget = ov.pop("gossip_budget", 0.1)
    cfg = get_config(arch).replace(**ov)
    shape = INPUT_SHAPES[shape_name]
    n_nodes, B = plan_nodes(shape, n_node_slots(mesh))
    sharded = shape.mode == "train" and mixing_impl in SHARDED_MIXINGS
    meta = dict(arch=arch, shape=shape_name, mode=shape.mode, mesh=mesh.name,
                n_nodes=n_nodes, batch_per_node=B, n_chips=n_nodes if sharded else 1,
                dtype=cfg.dtype)
    if sharded:  # one node per rank: the record's per-device numbers are rank 0's
        meta["nodes_per_device"] = 1
    if shape.mode == "train":
        tokens = shape.global_batch * (shape.seq_len if cfg.family != "cnn" else 1)
        meta["model_flops"] = model_flops(cfg, tokens, "train")
    elif shape.mode == "prefill":
        meta["model_flops"] = model_flops(cfg, shape.global_batch * shape.seq_len, "infer")
    else:
        meta["model_flops"] = model_flops(cfg, shape.global_batch, "infer")
    fn, args = build_step(cfg, shape.mode, n_nodes, B, shape.seq_len, device=device,
                          mixing_impl=mixing_impl, topology=topology, budget=gossip_budget)
    return fn, args, meta


def roofline_record(meta: dict, readings: dict, cfg, shape):
    """-> (record, Roofline): the reference's record from a build's
    ``meta`` and :func:`count_step`'s readings, with the roofline at the
    card's peaks for the step's dtype, the fused-HBM bound (tp=1, times the
    nodes: the whole program on one card) and ``fits``.  ``shape``: a name
    of ``INPUT_SHAPES`` or an ``InputShape``."""
    rec = dict(meta)
    rec.update(readings)
    r = Roofline(
        arch=meta["arch"], shape=shape if isinstance(shape, str) else shape.name,
        mesh=meta["mesh"],
        flops_dev=readings["flops_dev"], hbm_bytes_dev=readings["hbm_bytes_dev"],
        coll_bytes_dev=float(readings["coll"]["total"]), coll_breakdown=readings["coll"],
        model_flops_total=meta["model_flops"], n_chips=meta["n_chips"],
        peak_flops=peak_flops_for(cfg.tdtype),
    )
    rec["roofline"] = r.to_dict()
    # the model counts one node's traffic; the port holds every node on the
    # card (one node per rank under the sharded mixings)
    fused = meta.get("nodes_per_device", meta["n_nodes"]) * fused_hbm_bytes(
        cfg, shape, meta["n_nodes"], tp=1)
    rec["roofline"]["hbm_bytes_fused"] = fused
    rec["roofline"]["t_memory_fused"] = fused / HBM_BW
    mem = readings["memory"]
    rec["fits"] = mem["argument_bytes"] + mem["temp_bytes"] <= HBM_BYTES
    return rec, r


def run_one(arch: str, shape_name: str, multi_pod: bool = False, mixing_impl: str = "roll",
            topology: str = "regular", verbose: bool = True,
            overrides: Optional[dict] = None) -> dict:
    ok, reason = supports_shape(arch, shape_name)
    mesh_name = make_production_mesh(multi_pod=multi_pod).name
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    shape = INPUT_SHAPES[shape_name]
    group = contextlib.nullcontext()
    if shape.mode == "train" and mixing_impl in SHARDED_MIXINGS:
        group = node_group(plan_nodes(shape, n_node_slots(make_production_mesh(multi_pod=multi_pod)))[0])
    with group:
        fn, args, meta = build(arch, shape_name, multi_pod, mixing_impl, topology, overrides)
        meta["overrides"] = {**(overrides or {}), "mixing_impl": mixing_impl,
                             "topology": topology}
        _, readings = count_step(fn, args)
    cfg_ov = {k: v for k, v in (overrides or {}).items() if k != "gossip_budget"}
    rec, r = roofline_record(meta, readings, get_config(arch).replace(**cfg_ov),
                             INPUT_SHAPES[shape_name])
    rec.update(status="ok", device="meta", trace_s=round(time.time() - t0, 1))
    if verbose:
        mem = rec["memory"]
        print(f"[dryrun] {r.row()}")
        print(f"         mem {mem}  fits {rec['fits']}  trace {rec['trace_s']}s  "
              f"kernels {rec['kernels']['calls']}")
        print("         collectives: " + (", ".join(
            f"{k}={v/1e6:.1f}MB" for k, v in rec["coll"].items()
            if k not in ("count", "total") and v) or "none"))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mixing", default="roll",
                    choices=["roll", "shard_map", "dense", "sparse", "quant",
                             "sparse+quant"])
    ap.add_argument("--topology", default="regular",
                    choices=["ring", "regular", "fully", "dense"])
    ap.add_argument("--all", action="store_true", help="sweep every combo in subprocesses")
    ap.add_argument("--out", default=None, help="JSON output path (or dir for --all)")
    ap.add_argument("--attn", default=None, choices=["naive", "chunked"],
                    help="attention impl override (perf iteration)")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["on", "off"])
    ap.add_argument("--remat-policy", default=None, choices=["full", "save_comm"])
    ap.add_argument("--gossip-budget", type=float, default=None)
    args = ap.parse_args(argv)

    if args.all:
        sweep(args.out or "results/torch_dryrun", multi_pod=args.multi_pod)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    overrides = {}
    if args.attn:
        overrides["attn_impl"] = args.attn
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.remat:
        overrides["remat"] = args.remat == "on"
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.gossip_budget is not None:
        overrides["gossip_budget"] = args.gossip_budget
    rec = run_one(args.arch, args.shape, args.multi_pod, args.mixing, args.topology,
                  overrides=overrides)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


def sweep(out_dir: str, multi_pod: bool = False, jobs: int = 4):
    """Run every (arch x shape) in its own subprocess; collect JSONs."""
    import concurrent.futures as cf

    os.makedirs(out_dir, exist_ok=True)
    combos = [(a, s) for a in ARCHS if a != "gn-lenet" for s in INPUT_SHAPES] + [
        ("gn-lenet", "train_4k")
    ]

    def run(combo):
        a, s = combo
        tag = f"{a}__{s}__{'mp' if multi_pod else 'sp'}"
        out = os.path.join(out_dir, tag + ".json")
        if os.path.exists(out):
            return tag, "cached"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
               "--out", out]
        if multi_pod:
            cmd.append("--multi-pod")
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
        if p.returncode != 0:
            with open(out + ".err", "w") as f:
                f.write(p.stdout + "\n" + p.stderr)
            return tag, "FAILED"
        return tag, "ok"

    with cf.ThreadPoolExecutor(jobs) as ex:
        for tag, status in ex.map(run, combos):
            print(f"[sweep] {tag}: {status}", flush=True)


if __name__ == "__main__":
    main()
