"""The port's roofline and mesh against the JAX package's: ``Roofline``'s
terms, bottleneck, useful-FLOPs ratio, suggestion, row and record equal
the reference's given the same inputs and peaks, the defaults are the
H100's; ``CollectiveCounter`` sums c10d collective operand bytes under
the reference's keys over a one-process gloo group; the logical
production mesh has the reference's node axes and slots."""
import math

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)
from repro.launch import mesh as j_mesh
from repro.launch.roofline import Roofline as JRoofline
from repro_torch.core import engine as tengine
from repro_torch.launch import mesh
from repro_torch.launch.roofline import CollectiveCounter, Roofline, peak_flops_for

PEAKS = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
CASES = [  # (shape, flops_dev, hbm_bytes_dev, coll_bytes_dev, model_flops_total, n_chips)
    ("train_4k", 197e12, 819e9, 50e9, 197e12 * 256, 256),   # the three terms equal
    ("train_4k", 1e12, 819e9 * 5, 1e9, 1e12, 256),          # memory
    ("decode_32k", 1e12, 819e9 * 5, 1e9, 1e12, 16),         # memory, decode
    ("long_500k", 1e9, 1e9, 1e12, 1e11, 1),                 # collective
    ("prefill_32k", 5e14, 1e9, 0.0, 2e14, 1),               # compute
    ("train_4k", 0.0, 1e9, 0.0, 1e9, 1),                    # no flops: ratio nan
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("peaks", ["reference", "h100"])
def test_roofline_equals_the_reference(case, peaks):
    shape, flops, nbytes, coll, model, chips = case
    kw = PEAKS if peaks == "reference" else dict(
        peak_flops=mesh.PEAK_FLOPS_BF16, hbm_bw=mesh.HBM_BW, ici_bw=mesh.NVLINK_BW)
    args = dict(arch="qwen3-32b", shape=shape, mesh="16x16", flops_dev=flops,
                hbm_bytes_dev=nbytes, coll_bytes_dev=coll,
                coll_breakdown={"all-reduce": int(coll)}, model_flops_total=model, n_chips=chips)
    got, want = Roofline(**args, **kw), JRoofline(**args, **kw)
    for name in ("t_compute", "t_memory", "t_collective"):
        assert getattr(got, name) == getattr(want, name)
    assert got.bottleneck == want.bottleneck
    if math.isnan(want.useful_flops_ratio):
        assert math.isnan(got.useful_flops_ratio)
    else:
        assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.suggestion() == want.suggestion()
    assert got.row() == want.row()
    g, w = got.to_dict(), want.to_dict()
    assert g.keys() == w.keys()
    assert {k: v for k, v in g.items() if k != "useful_flops_ratio"} == \
        {k: v for k, v in w.items() if k != "useful_flops_ratio"}


def test_defaults_are_the_h100s():
    r = Roofline(arch="a", shape="s", mesh="16x1", flops_dev=989e12, hbm_bytes_dev=3.35e12,
                 coll_bytes_dev=450e9, coll_breakdown={}, model_flops_total=989e12,
                 n_chips=1)
    assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (989e12, 3.35e12, 450e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1.0)
    assert peak_flops_for(torch.bfloat16) == mesh.PEAK_FLOPS_BF16 == 989e12
    assert peak_flops_for(torch.float32) == mesh.PEAK_FLOPS_FP32 == 67e12
    assert (mesh.PEAK_FLOPS_TF32, mesh.HBM_BYTES) == (495e12, 80e9)


@pytest.fixture
def one_process_group():
    """A one-process gloo group from an in-memory store, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_collective_counter_counts_operand_bytes(one_process_group):
    x = torch.ones(1024)                       # 4096 bytes
    with CollectiveCounter() as c:
        y = x * 2 + 1                          # no collective
        assert c.result()["count"] == 0 and c.result()["total"] == 0
        dist.all_reduce(y)
        out = [torch.empty(512)]
        dist.all_gather(out, x[:512])         # the operand: 2048 bytes
        dist.broadcast(torch.ones(10, dtype=torch.float64), 0)   # 80 bytes
    got = c.result()
    assert got == {"all-gather": 2048, "all-reduce": 4096, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 80, "count": 3, "total": 6224}
    assert torch.equal(y, x * 2 + 1) and torch.equal(out[0], x[:512])


def test_collective_counter_reads_zero_outside_collectives():
    with CollectiveCounter() as c:
        torch.ones(64).sum()
    assert c.result() == {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                          "all-to-all": 0, "collective-permute": 0, "count": 0, "total": 0}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_has_the_references_node_axes(multi_pod):
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    ref = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        AbstractMesh((16, 16), ("data", "model"))
    assert mesh.node_axes(m) == j_mesh.node_axes(ref)
    assert mesh.n_node_slots(m) == j_mesh.n_node_slots(ref) == (32 if multi_pod else 16)
    assert m.shape["model"] == 1 and m.size == mesh.n_node_slots(m)
    assert m.name == ("2x16x1" if multi_pod else "16x1")


def test_node_mesh_on_the_cpu(monkeypatch):
    """Asked for the CPU (``device='cpu'``): a 1-D mesh of one rank over a
    one-process gloo group it starts; asking for more devices raises as
    the reference does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    try:
        m = mesh.make_node_mesh(device="cpu")
        assert m.mesh_dim_names == ("nodes",) and m.size() == 1 and m.device_type == "cpu"
        assert mesh.node_axes(m) == ("nodes",) and mesh.n_node_slots(m) == 1
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="only 1 are visible"):
            mesh.make_node_mesh(2, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("n_devices", [0, 2])
def test_node_mesh_without_a_card_raises(monkeypatch, n_devices):
    """``device=None`` means the card: without one the mesh raises, names
    ``device='cpu'`` as the engine's ``resolve_device`` does, and starts no
    process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available; pass device='cpu'"):
        mesh.make_node_mesh(n_devices)
    with pytest.raises(RuntimeError) as err:
        tengine.resolve_device(None)
    assert str(err.value) == "no CUDA device is available; pass device='cpu' to run on the CPU"
    assert not dist.is_initialized()
