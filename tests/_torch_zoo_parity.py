"""Shared pieces of the zoo parity tests (``tests/test_torch_{mla,encdec,vlm}.py``):
configs and parameter trees carried from the JAX package into the port, the
greedy-ids comparison of the two serving engines, and one decentralized
train step through the reference's jitted ``make_train_step``.

Parameters are the JAX package's inits plus numpy noise (so zero biases and
unit norms are exercised), carried over by ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (re-exported autouse fixture)

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.optim import make_optimizer as jmake_opt
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.training import trainer as jtrainer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.training import trainer as ttrainer
from repro_torch.utils.pytree import tree_leaves


def tcfg(cfg):
    """The port's config of a JAX config, field for field."""
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


def jax_params(cfg, noise_seed, scale=0.05, lead=None):
    """The JAX package's init of ``cfg`` (key 0) plus noise, as numpy."""
    base = jax.jit(lambda key: japi.init_params(cfg, key))(jax.random.key(0))
    return noisy(base, noise_seed, scale, lead)


def both(tree):
    """(JAX tree, torch tree) of one numpy tree."""
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree)


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def check_greedy_ids(arch, max_new=6, noise_seed=5):
    """``ServingEngine.generate`` greedy ids of the smoke config equal to the
    JAX engine's, from the same parameters and prompts."""
    jcfg, cfg = jsmoke(arch), get_smoke_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = jax_params(jcfg, noise_seed)
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab, (2, 16)).astype(np.int32)
    want = JServingEngine(jcfg, JServeConfig(batch=2, max_len=24),
                          jax.tree_util.tree_map(jnp.asarray, params)).generate(
        jnp.asarray(prompts), max_new=max_new)
    got = ServingEngine(cfg, ServeConfig(batch=2, max_len=24), params_from_jax(params),
                        "cpu").generate(torch.as_tensor(prompts), max_new=max_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


def check_train_step(arch, n=4, topology="ring", lr=3e-2):
    """One SGD step (clip 1.0) of the smoke config on ``n`` nodes from the
    same noisy JAX parameters: the reference's jitted step against the
    port's; loss and every parameter within 1e-5."""
    cfg = jsmoke(arch)
    params = jax_params(cfg, 3, scale=0.02, lead=n)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (n, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    jtc = jtrainer.TrainConfig(n_nodes=n, topology=topology, grad_clip=1.0)
    jstep = jax.jit(jtrainer.make_train_step(cfg, jmake_opt("sgd", lr), jtc))
    want_p, _, want_loss = jstep(jax.tree_util.tree_map(jnp.asarray, params), (),
                                 jax.tree_util.tree_map(jnp.asarray, batch))
    tstep = ttrainer.make_train_step(tcfg(cfg), tmake_opt("sgd", lr),
                                     ttrainer.TrainConfig(n_nodes=n, topology=topology))
    got_p, _, loss = tstep(params_from_jax(params), (),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want_p)
    assert len(tree_leaves(got_p)) == len(want_leaves)
    for g, w in zip(tree_leaves(got_p), want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert sorted(got_p) == sorted(want_p)
    return got_p


def check_bf16_bitwise(arch):
    """The JAX init of the smoke config in bf16 carried by
    ``params_from_jax`` bitwise, leaf for leaf, with every leaf's path."""
    cfg = jsmoke(arch).replace(dtype="bfloat16")
    jp = jax.jit(lambda key: japi.init_params(cfg, key))(jax.random.key(0))
    tp = params_from_jax(jp)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jp)]
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        want = np.asarray(a).view(np.uint16)
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want)
    return paths
