"""Port parity of the MoE family and the dense zoo configs against the JAX
package on the CPU: ``moe_apply`` (top-1 and top-2 routing, shared
experts, capacity drops forced by a small ``capacity_factor``) outputs and
aux loss within 1e-5; one decentralized train step of the
Llama4-Maverick smoke config (MoE every second layer, 4 experts and a
shared one) through the reference's jitted ``make_train_step``, loss and
parameters within 1e-5; ``ServingEngine`` greedy ids equal to the JAX
engine's on the MoE and the three dense GQA smoke configs (qk-norm, QKV
bias, rope_theta 1e6); and ``param_count`` of every newly ported config
at full size equal to the reference's (the port counts on the ``meta``
device).

Parameters are the JAX package's inits plus numpy noise (so zero biases
and unit norms are exercised), carried over by ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.optim import make_optimizer as jmake_opt
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.training import trainer as jtrainer
from repro_torch.configs import PORTED, get_config, get_smoke_config, supports_shape
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.training import trainer as ttrainer
from repro_torch.utils.pytree import tree_leaves

NEW = ("qwen3-32b", "qwen2-72b", "mistral-large-123b", "llama4-maverick-400b-a17b", "gn-lenet")
LLAMA4 = "llama4-maverick-400b-a17b"


def tcfg(cfg):
    return TConfig(**dataclasses.asdict(cfg))


def noisy(tree, seed, scale=0.05, lead=None):
    """The tree as numpy, each float leaf plus scaled normal noise (stacked
    ``lead`` times with noise of its own where given)."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if lead is not None:
            a = np.broadcast_to(a, (lead,) + a.shape)
        return (a + scale * rng.normal(size=a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(f, tree)


def _moe_cfg(E, k, cap, shared):
    return JConfig(name="t", family="moe", d_model=32, d_ff=64, d_expert=48, n_experts=E,
                   moe_top_k=k, n_shared_experts=shared, capacity_factor=cap,
                   aux_loss_coef=0.01)


@pytest.mark.parametrize("E,k,cap,shared", [
    (4, 1, 4.0, 0),    # no drops
    (4, 2, 8.0, 1),    # top-2, a shared expert
    (8, 3, 0.25, 0),   # capacity 8 of 24 choices per expert: drops
    (4, 1, 0.3, 1),    # drops with a shared expert
])
def test_moe_apply_matches_jax(E, k, cap, shared):
    cfg = _moe_cfg(E, k, cap, shared)
    p = noisy(jax.jit(jmoe.moe_init, static_argnums=1)(jax.random.key(0), cfg), 1)
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(jmoe.moe_apply, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(x))
    got, aux = tmoe.moe_apply(params_from_jax(p), tcfg(cfg), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    C = tmoe._capacity(48, k, E, cap)
    assert C == jmoe._capacity(48, k, E, cap)
    if cap < 1:  # some (token, choice) entries exceed their expert's capacity
        assert E * C < 48 * k


def test_llama4_train_step_matches_jax():
    """One SGD step (clip 1.0) of the smoke config on a 4-node ring, from
    the same noisy JAX parameters; the reference's jitted step."""
    cfg, n = jsmoke(LLAMA4), 4
    base = jax.jit(lambda key: japi.init_params(cfg, key))(jax.random.key(0))
    params = noisy(base, 3, scale=0.02, lead=n)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (n, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    jtc = jtrainer.TrainConfig(n_nodes=n, topology="ring", grad_clip=1.0)
    jstep = jax.jit(jtrainer.make_train_step(cfg, jmake_opt("sgd", 3e-2), jtc))
    want_p, _, want_loss = jstep(jax.tree_util.tree_map(jnp.asarray, params), (),
                                 jax.tree_util.tree_map(jnp.asarray, batch))
    tstep = ttrainer.make_train_step(tcfg(cfg), tmake_opt("sgd", 3e-2),
                                     ttrainer.TrainConfig(n_nodes=n, topology="ring"))
    got_p, _, loss = tstep(params_from_jax(params), (),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want_p)
    assert len(tree_leaves(got_p)) == len(want_leaves)
    for g, w in zip(tree_leaves(got_p), want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert sorted(got_p) == sorted(want_p) and "group_dense" in got_p and "group_moe" in got_p


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2-72b", "mistral-large-123b", LLAMA4])
def test_generate_greedy_ids_equal_jax(arch):
    jcfg, cfg = jsmoke(arch), get_smoke_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = noisy(jax.jit(lambda key: japi.init_params(jcfg, key))(jax.random.key(0)), 5)
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab, (2, 16)).astype(np.int32)
    want = JServingEngine(jcfg, JServeConfig(batch=2, max_len=24),
                          jax.tree_util.tree_map(jnp.asarray, params)).generate(
        jnp.asarray(prompts), max_new=6)
    got = ServingEngine(cfg, ServeConfig(batch=2, max_len=24), params_from_jax(params),
                        "cpu").generate(torch.as_tensor(prompts), max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the prefill's cache and the zeroed cache have the reference's layout
    jc = jax.eval_shape(lambda p, t: japi.prefill(p, jcfg, {"tokens": t}, 24)[1],
                        params, prompts)
    tc = tapi.prefill(params_from_jax(params), cfg, {"tokens": torch.as_tensor(prompts)}, 24)[1]
    zc = tapi.init_cache(cfg, 2, 24)
    for c in (tc, zc):
        assert sorted(c) == sorted(jc)
        for name in c:
            assert {k: tuple(v.shape) for k, v in c[name].items()} == {
                k: tuple(v.shape) for k, v in jc[name].items()}


@pytest.mark.parametrize("arch", NEW)
def test_param_count_at_full_size_equals_jax(arch):
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget(arch))
    assert arch in PORTED
    assert tapi.param_count(cfg) == japi.param_count(jget(arch))


def test_registry_shapes_as_the_reference():
    from repro.configs import supports_shape as jsupports

    for arch in NEW:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert supports_shape(arch, shape) == jsupports(arch, shape)
