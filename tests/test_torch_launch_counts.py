"""The port's model counts and launch specs against the JAX package's,
exactly, for every architecture of the registry at its published width:
``param_specs`` and ``cache_specs`` (the reference's ``PartitionSpec``s
as tuples), ``active_param_count`` and ``model_flops``; ``plan_nodes``
and ``node_spec`` for every input shape at 1, 16 and 32 node slots; and
``fused_hbm_bytes`` for every supported (arch x shape) at tp 16 and 1.
Every count comes from shapes alone (``jax.eval_shape`` in the reference,
the ``meta`` device in the port)."""
import jax
import pytest
from jax.sharding import PartitionSpec

from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)
from repro.configs import ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import supports_shape as j_supports_shape
from repro.launch import analytic as j_analytic
from repro.launch import specs as j_specs
from repro.models import api as j_api
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, supports_shape
from repro_torch.launch import analytic, specs
from repro_torch.models import api

SLOTS = ((1, ("nodes",)), (16, ("data",)), (32, ("pod", "data")))


def _jax_specs(tree):
    """{dotted path: leaf} of a reference tree, a PartitionSpec leaf as
    its tuple of entries."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {".".join(str(k.key) for k in path):
            tuple(leaf) if isinstance(leaf, PartitionSpec) else leaf for path, leaf in leaves}


def _torch_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_torch_specs(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_the_registries_agree():
    assert ARCHS == J_ARCHS
    assert {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for leading in ((), ("nodes",), (("pod", "data"),)):
        assert _torch_specs(api.param_specs(cfg, leading=leading)) == _jax_specs(
            j_api.param_specs(jcfg, leading=leading))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "gn-lenet"])
def test_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for batch, max_len, leading in ((2, 64, ()), (8, 4096, ("data",))):
        assert _torch_specs(api.cache_specs(cfg, batch, max_len, leading=leading)) == _jax_specs(
            j_api.cache_specs(jcfg, batch, max_len, leading=leading))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert api.param_count(cfg) == j_api.param_count(jcfg)
    assert api.active_param_count(cfg) == j_api.active_param_count(jcfg)
    for tokens, mode in ((256 * 4096, "train"), (32 * 32_768, "infer"), (128, "infer")):
        assert api.model_flops(cfg, tokens, mode) == j_api.model_flops(jcfg, tokens, mode)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_plan_nodes_and_node_spec_equal_the_reference(shape):
    for n_slots, axes in SLOTS:
        plan = specs.plan_nodes(INPUT_SHAPES[shape], n_slots)
        assert plan == j_specs.plan_nodes(J_SHAPES[shape], n_slots)
        for n_nodes in sorted({1, plan[0], n_slots // 2 or 1, n_slots}):
            assert specs.node_spec(n_nodes, n_slots, axes) == j_specs.node_spec(
                n_nodes, n_slots, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_hbm_bytes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    n = 0
    for shape in INPUT_SHAPES:
        ok, reason = supports_shape(arch, shape)
        assert (ok, reason) == j_supports_shape(arch, shape)
        if not ok:
            continue
        n_nodes, _ = specs.plan_nodes(INPUT_SHAPES[shape], 16)
        for tp in (16, 1):
            assert analytic.fused_hbm_bytes(cfg, shape, n_nodes, tp=tp) == \
                j_analytic.fused_hbm_bytes(jcfg, shape, n_nodes, tp=tp)
            n += 1
    assert n >= 2


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b", "whisper-tiny",
                                  "qwen2-vl-72b", "gn-lenet"])
def test_stacked_input_shapes_equal_the_reference(arch):
    """``batch_specs``, ``stacked_param_shapes`` and ``decode_specs`` as
    ``meta`` tensors of the reference's ``ShapeDtypeStruct`` shapes and
    dtypes, and the batch partition specs as tuples."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = INPUT_SHAPES["train_4k"]
    got = specs.batch_specs(cfg, shape, 16, 16)
    want = j_specs.batch_specs(jcfg, J_SHAPES["train_4k"], 16, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1], v.device.type)
            for k, v in got.items()} == {k: (tuple(v.shape), str(v.dtype), "meta")
                                         for k, v in want.items()}
    assert specs.batch_partition_specs(got, "data") == {
        k: tuple(v) for k, v in j_specs.batch_partition_specs(want, "data").items()}
    p_got = _torch_specs(specs.stacked_param_shapes(cfg, 4))
    p_want = _jax_specs(j_specs.stacked_param_shapes(jcfg, 4))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in p_got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in p_want.items()}
    assert _torch_specs(specs.stacked_param_specs(cfg, "data")) == _jax_specs(
        j_specs.stacked_param_specs(jcfg, "data"))
    if cfg.family != "cnn":
        cache, toks = specs.decode_specs(cfg, INPUT_SHAPES["decode_32k"], 16, 8)
        j_cache, j_toks = j_specs.decode_specs(jcfg, J_SHAPES["decode_32k"], 16, 8)
        assert {k: tuple(v.shape) for k, v in _torch_specs(cache).items()} == {
            k: tuple(v.shape) for k, v in _jax_specs(j_cache).items()}
        assert tuple(toks.shape) == tuple(j_toks.shape) and toks.device.type == "meta"
