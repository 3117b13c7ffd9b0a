"""The port's dry run (``repro_torch.launch.dryrun``): the step executed on
the ``meta`` device under the counters allocates no storage elsewhere, and
reads the same flops, bytes, live-storage peak and kernel charges as the
same step run on the CPU at that size, for the smoke config of every
family in every mode it has; a train step over more than 5 nodes charges
the merge's cost function for its (N, P) exactly; the records carry the
reference's keys and its skip records; the CLI's JSONs render in
``benchmarks/bench_roofline.py``'s table.  The reference's
``launch/dryrun.py`` sets a 512-device XLA flag at import, so it runs in a
subprocess only."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)
from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_smoke_config, supports_shape
from repro_torch.core.mixing import mix_circulant
from repro_torch.kernels import cost
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.kernels import swa_attention as tswa
from repro_torch.launch import dryrun as dr
from repro_torch.optim import sgd
from repro_torch.training import trainer as ttrainer
from repro_torch.utils.pytree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "qwen3-32b", "moe": "llama4-maverick-400b-a17b", "mla": "deepseek-v2-236b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b", "encdec": "whisper-tiny",
            "vlm": "qwen2-vl-72b", "cnn": "gn-lenet"}
CASES = [(fam, mode) for fam in FAMILIES
         for mode in (("train",) if fam == "cnn" else ("train", "prefill", "decode", "forward"))]
# the reference's record keys (launch/dryrun.py run_one), its lower_s and
# compile_s replaced by trace_s
REF_KEYS = {"arch", "shape", "mode", "mesh", "n_nodes", "batch_per_node", "n_chips",
            "model_flops", "overrides", "status", "flops_dev", "hbm_bytes_dev", "coll",
            "memory", "roofline"}
PORT_KEYS = {"trace_s", "fits", "device", "dtype", "kernels"}
ROOFLINE_KEYS = {"arch", "shape", "mesh", "flops_dev", "hbm_bytes_dev", "coll_bytes_dev",
                 "coll_breakdown", "model_flops_total", "n_chips", "peak_flops", "hbm_bw",
                 "ici_bw", "t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flops_ratio", "hbm_bytes_fused", "t_memory_fused"}
# cut input shapes under the suite's names, for the smoke configs' records
SMALL_SHAPES = {"train_4k": InputShape("train_4k", 16, 32, "train"),
                "prefill_32k": InputShape("prefill_32k", 32, 4, "prefill"),
                "decode_32k": InputShape("decode_32k", 32, 16, "decode"),
                "long_500k": InputShape("long_500k", 64, 1, "decode")}


class StorageWatch(TorchDispatchMode):
    """The devices of every op's outputs, leaving out 0-dim CPU tensors:
    the python scalars that ``torch.func`` wraps (``0.04 * tensor``) as it
    does on every device."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.devices.update(t.device.type for t in dr._tensors(out)
                            if t.dim() or t.device.type != "cpu")
        return out


def _case(cfg, mode, device):
    n = 8 if mode == "train" else 2
    return dr.build_step(cfg, mode, n, 2, 32 if mode == "decode" else 16, device=device)


@pytest.mark.parametrize("family,mode", CASES)
def test_meta_run_reads_what_a_cpu_run_reads(family, mode):
    cfg = get_smoke_config(FAMILIES[family])
    with StorageWatch() as watch:
        fn, args = _case(cfg, mode, "meta")
        _, meta = dr.count_step(fn, args)
    assert watch.devices == {"meta"}
    fn, args = _case(cfg, mode, "cpu")
    out, cpu = dr.count_step(fn, args)
    assert all(bool(torch.isfinite(t.float()).all()) for t in dr._tensors(out))
    assert meta == cpu
    assert meta["flops_dev"] > 0 and meta["hbm_bytes_dev"] > 0
    assert meta["memory"]["temp_bytes"] > 0 and meta["memory"]["generated_code_bytes"] is None
    assert meta["coll"]["total"] == 0
    if mode == "train":
        # more than 5 nodes: the regular overlay, one merge over the (N, P) buffer
        (X,) = ttrainer.flat_buffers(args[0])
        flops, nbytes = gm.merge_cost(8, 6, X.shape[1], X.element_size(), 8)
        assert meta["kernels"] == {"calls": {"gossip_mix_rows": 1}, "flops": flops,
                                   "bytes": nbytes}
    else:
        assert meta["kernels"] == {"calls": {}, "flops": 0, "bytes": 0}


def test_the_byte_counter_skips_views_and_counts_in_place_writes_once():
    x = torch.ones((4, 8))
    with dr.ByteCounter() as c:
        x.t().reshape(8, 4)[None].expand(3, 8, 4)   # views only
        assert c.bytes == 0
        x.add_(1.0)                                  # written once: 128 bytes
        assert c.bytes == 128
        y = x + x                                    # x read once, y written
        assert c.bytes == 128 + 256
        x[None].expand(5, 4, 8) * 2.0                # the broadcast read once
        assert c.bytes == 128 + 256 + 128 + 5 * 128
    del y


def test_the_live_tracker_counts_a_storage_once_and_frees_it():
    with dr.LiveTracker() as live:
        a = torch.empty(1000)                        # 4000 bytes
        b = a[:10].view(2, 5)                        # the same storage
        c = torch.empty(500)                         # 2000 bytes
        assert live.peak == 6000
        del a, b, c
        d = torch.empty(1200)                        # 4800 bytes: live again below the peak
        e = torch.empty(600)                         # 2400 bytes: a new peak of 7200
    assert live.peak == 7200
    del d, e


def test_the_live_tracker_sees_logsumexps_own_temporary():
    """logsumexp computes exp(x - max) into a temporary of x's size inside
    the op (as the card's allocator shows): the peak holds it beside x."""
    x = torch.randn((64, 100))                       # 25,600 bytes, an argument
    with dr.LiveTracker() as live:
        live.skip = {dr.StorageWeakRef(x.untyped_storage()).cdata}
        torch.logsumexp(x, -1)                       # 64 x 4 bytes of output
    assert live.peak == 25_600


def test_a_train_step_over_two_dtypes_merges_one_buffer_each():
    """Mamba2's fp32 decay leaves beside bf16 weights: the trainer holds one
    flat buffer per dtype and merges each once; the mixed leaves equal the
    merge of each updated leaf."""
    cfg = get_smoke_config("mamba2-370m").replace(dtype="bfloat16")
    fn, args = _case(cfg, "train", "meta")
    _, meta = dr.count_step(fn, args)
    assert meta["kernels"]["calls"] == {"gossip_mix_rows": 2}
    fn, (params, opt_state, batch) = _case(cfg, "train", "cpu")
    bufs = ttrainer.flat_buffers(params)
    assert {X.dtype for X in bufs} == {torch.bfloat16, torch.float32}
    tc = ttrainer.TrainConfig(n_nodes=8, topology="regular", degree=5)
    copy = ttrainer.stack_node_params(tree_map(lambda a: a.clone(), params))
    updated, _, _ = ttrainer.make_node_train_step(cfg, sgd(1e-2), tc)(copy, opt_state, batch)
    mixed, _, _ = fn(params, opt_state, batch)
    for got, upd in zip(tree_leaves(mixed), tree_leaves(updated)):
        assert got.dtype == upd.dtype
        torch.testing.assert_close(got, mix_circulant(upd, 8, 5), rtol=0, atol=0)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_the_kernel_wrappers_charge_their_cost(device):
    """On ``meta`` the three wrappers check their inputs and return empty
    results; on the CPU under a tally they return the twin's values; both
    charge the kernels' cost functions."""
    g = torch.Generator().manual_seed(0)
    X, w = torch.randn((6, 40), generator=g), torch.rand((4, 3), generator=g)
    rows = torch.randint(0, 6, (4, 3), generator=g, dtype=torch.int32)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    xdt, bc, cc = (torch.randn(s, generator=g) for s in ((3, 8, 2, 4), (3, 8, 5), (3, 8, 5)))
    cum = -torch.rand((3, 8, 2), generator=g).cumsum(1)
    on = lambda *ts: [t.to(device) for t in ts]
    with cost.charging() as tally:
        m = gm.gossip_mix_rows(*on(X, rows, w))
        a = tswa.swa_attention_gqa(*on(q, k, v), 5)
        y, st, dec = tssd.ssd_chunk(*on(xdt, bc, cc, cum))
    want = [gm.merge_cost(4, 3, 40, 4, 6), tswa.swa_cost(2, 16, 4, 2, 8, 5, 4),
            tssd.ssd_cost(3, 8, 2, 4, 5)]
    assert tally.flops == sum(f for f, _ in want) and tally.bytes == sum(b for _, b in want)
    assert tally.calls == {"gossip_mix_rows": 1, "swa_attention_gqa": 1, "ssd_chunk": 1}
    assert [tuple(t.shape) for t in (m, a, y, st, dec)] == [(4, 40), (2, 16, 4, 8), (3, 8, 2, 4),
                                                            (3, 2, 5, 4), (3, 2)]
    assert {t.device.type for t in (m, a, y, st, dec)} == {device}
    if device == "cpu":
        assert torch.equal(m, gm.gossip_mix_rows_ref(X, rows, w))
        assert torch.equal(a, tswa.swa_attention_gqa_ref(q, k, v, 5))
        for got, ref in zip((y, st, dec), tssd.ssd_chunk_ref(xdt, bc, cc, cum)):
            assert torch.equal(got, ref)
    with cost.charging(), pytest.raises(ValueError):  # the CUDA route's shape check
        gm.gossip_mix_rows(*on(X, rows, w[:, :2]))


def _small_run_one(monkeypatch, arch, shape):
    monkeypatch.setattr(dr, "get_config", get_smoke_config)
    monkeypatch.setattr(dr, "INPUT_SHAPES", SMALL_SHAPES)
    return dr.run_one(arch, shape, verbose=False)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_records_carry_the_references_keys(monkeypatch, family):
    arch = FAMILIES[family]
    for shape in (("train_4k",) if family == "cnn" else ("train_4k", "decode_32k")):
        with StorageWatch() as watch:
            rec = _small_run_one(monkeypatch, arch, shape)
        assert watch.devices == {"meta"}
        assert set(rec) == REF_KEYS | PORT_KEYS, set(rec) ^ (REF_KEYS | PORT_KEYS)
        assert set(rec["roofline"]) == ROOFLINE_KEYS
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "generated_code_bytes"}
        assert rec["status"] == "ok" and rec["device"] == "meta" and rec["n_chips"] == 1
        assert rec["mesh"] == "16x1" and rec["n_nodes"] == (16 if shape == "train_4k" else 16)
        assert rec["fits"] is True and rec["roofline"]["t_collective"] == 0.0
        json.dumps(rec)


@pytest.mark.parametrize("arch,shape", [("llama4-maverick-400b-a17b", "train_4k"),
                                        ("deepseek-v2-236b", "decode_32k")])
def test_published_width_dry_run_allocates_nothing(arch, shape, capsys):
    with StorageWatch() as watch:
        rec = dr.run_one(arch, shape)
    assert watch.devices == {"meta"}
    assert rec["status"] == "ok" and not rec["fits"]
    assert rec["flops_dev"] > 0 and rec["roofline"]["bottleneck"] == "memory"
    assert f"[dryrun] {arch}" in capsys.readouterr().out


def test_sanitize_specs_drops_sharding_the_mesh_does_not_divide():
    """Whisper's 51,865-word vocab over a model axis of 16 loses its
    sharding; on the port's mesh (model axis 1) every spec stays."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import LogicalMesh, make_production_mesh
    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny")
    shapes = specs.stacked_param_shapes(cfg, 16)
    pspecs = specs.stacked_param_specs(cfg, "data")
    wide = dr.sanitize_specs(shapes, pspecs, LogicalMesh(("data", "model"), (16, 16)))
    assert pspecs["embed"] == ("data", "model", None) and wide["embed"] == ("data", None, None)
    assert wide["dec_layers"]["attn"]["w_q"] == pspecs["dec_layers"]["attn"]["w_q"]
    assert dr.sanitize_specs(shapes, pspecs, make_production_mesh()) == pspecs


def test_sharded_mixing_raises_naming_item_6(tmp_path):
    """The sharded mixings (ROADMAP Queue 1 item 6, once refused here) dry
    run as rank 0 of a fake 16-rank group on ``meta``: one node's step,
    whose collective counter reads the point-to-point operand bytes of
    the circulant's links, each the node's parameters (for 'quant' int8
    codes of the zero-padded rows and one fp32 scale per row), plus the
    mean loss's all-reduce."""
    from repro_torch.core.topology import circulant_offsets
    from repro_torch.launch.mesh import make_production_mesh, n_node_slots
    from repro_torch.launch.specs import plan_nodes

    arch, shape = "smollm-135m", "train_4k"
    n = plan_nodes(INPUT_SHAPES[shape], n_node_slots(make_production_mesh()))[0]
    links = sum(1 if 2 * o % n == 0 else 2 for o in circulant_offsets(n, 5))
    leaves = tree_leaves(dr._stacked_params(dr.get_config(arch), 1, "meta", 0))

    def codes(leaf):  # rows of min(2^20, size) elements, zero-padded
        row = min(1 << 20, leaf.numel())
        rows = -(-leaf.numel() // row)
        return rows * row + 4 * rows

    for impl, per_leaf in (("shard_map", lambda l: l.numel() * l.element_size()),
                           ("quant", codes)):
        out = tmp_path / f"{impl}.json"
        dr.main(["--arch", arch, "--shape", shape, "--mixing", impl, "--out", str(out)])
        rec = json.loads(out.read_text())
        assert rec["status"] == "ok" and rec["n_chips"] == n and rec["nodes_per_device"] == 1
        assert rec["coll"]["collective-permute"] == links * sum(per_leaf(l) for l in leaves)
        assert rec["coll"]["all-reduce"] == 4  # the loss summed over the ranks
    assert not torch.distributed.is_initialized()


def test_skip_records_equal_the_references():
    pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES if not supports_shape(a, s)[0]]
    assert pairs
    script = ("import json, sys\nfrom repro.launch.dryrun import run_one\n"
              f"print(json.dumps([run_one(a, s, False) for a, s in {pairs!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = [dr.run_one(a, s, verbose=False) for a, s in pairs]
    for g, w in zip(got, want, strict=True):
        assert g.pop("mesh") == "16x1" and w.pop("mesh") == "16x16"
        assert g == w


def test_cli_json_renders_in_the_roofline_table(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for arch, shape in (("gn-lenet", "train_4k"), ("qwen3-32b", "long_500k")):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--out", str(tmp_path / f"{arch}__{shape}.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from benchmarks.bench_roofline import load, table; "
         "print(table(load([sys.argv[1]])))", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4
    assert lines[2].startswith("| gn-lenet | train_4k | 16x1 |") and "**compute**" in lines[2]
    assert lines[3].startswith("| qwen3-32b | long_500k | 16x1 | — |") and "SKIP" in lines[3]
