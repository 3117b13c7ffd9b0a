"""Port parity: the optimizers over node-stacked trees (momentum with and
without Nesterov's variant, AdamW, the global norm and its clip) against
``jax.vmap`` of the JAX package's per-node optimizers; the MLP and its
converter; per-node learning rates and AdamW through the whole engine.

Tolerances: updates and optimizer states within 1e-6 after several
steps; MLP logits within 1e-5; engine runs as ``_torch_engine_parity``
says.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from _torch_engine_parity import (
    WHOLE,
    assert_run_metrics_match,
    assert_whole_run_tracks,
    jax_run,
    torch_run,
)
from repro.models.mlp import mlp_apply as jmlp_apply
from repro.models.mlp import mlp_init as jmlp_init
from repro.optim import optimizers as jopt
from repro_torch.convert import mlp_params_from_jax
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.optim import optimizers as topt
from repro_torch.utils.pytree import tree_leaves

N = 5


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(N, 7, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(N, 11)).astype(np.float32),
                  "d": rng.normal(size=(N,)).astype(np.float32)}}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


def _close(got, want, atol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


OPTS = [("momentum", dict(beta=0.9)), ("momentum", dict(beta=0.8, nesterov=True)),
        ("adamw", {}), ("adamw", dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1))]


@pytest.mark.parametrize("name,kw", OPTS)
def test_optimizer_steps_match_vmapped_jax(name, kw):
    """Four steps on node-stacked trees, one node sitting out the third
    (its state kept, as the engine does under churn): updates and states
    within 1e-6 of ``vmap`` of the JAX optimizer; AdamW's count per node."""
    jo, to = jopt.make_optimizer(name, 0.05, **kw), topt.make_optimizer(name, 0.05, **kw)
    params = _tree(0)
    js, ts = jax.vmap(jo.init)(_j(params)), to.init(_t(params))
    _close(ts, js, 0)
    for step in range(4):
        g = _tree(step + 1)
        ju, js2 = jax.vmap(jo.update)(_j(g), js, _j(params))
        tu, ts2 = to.update(_t(g), ts, _t(params))
        _close(tu, ju, 1e-6)
        _close(ts2, js2, 1e-6)
        if step == 2:  # node 1 down: keep its state
            keep = np.arange(N) != 1
            js2 = jax.tree_util.tree_map(
                lambda n, o: jnp.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), js2, js)
            ts2 = jax.tree_util.tree_map(
                lambda n, o: torch.where(torch.tensor(keep).reshape((-1,) + (1,) * (n.dim() - 1)),
                                         n, o), ts2, ts)
        js, ts = js2, ts2
        params = jax.tree_util.tree_map(lambda p, u: p + np.asarray(u), params, ju)
    if name == "adamw":
        assert ts["t"].dtype == torch.int32 and ts["t"].tolist() == [4, 3, 4, 4, 4]


def test_global_norm_and_clip_per_node():
    g = _tree(7)
    want = jax.vmap(jopt.global_norm)(_j(g))
    got = topt.global_norm(_t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    for max_norm in (0.5, float(np.asarray(want)[2]), 1e3):
        _close(topt.clip_by_global_norm(_t(g), max_norm),
               jax.vmap(lambda t: jopt.clip_by_global_norm(t, max_norm))(_j(g)), 1e-6)


def test_unknown_optimizer_raises_as_in_jax():
    for mod in (jopt, topt):
        with pytest.raises(ValueError, match="unknown optimizer"):
            mod.make_optimizer("lion", 0.1)


@pytest.mark.parametrize("hidden,shape", [(128, (6, 32, 32, 3)), (8, (3, 4, 4, 2))])
def test_mlp_forward_matches_jax(hidden, shape):
    """The JAX package's initial MLP through the converter: same leaves
    bitwise, logits within 1e-5; the port's own init has the same shapes."""
    in_dim = int(np.prod(shape[1:]))
    jp = jmlp_init(jax.random.key(3), in_dim=in_dim, hidden=hidden)
    tp = mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(mlp_apply(tp, torch.tensor(x)).numpy(),
                               np.asarray(jmlp_apply(jp, jnp.asarray(x))), atol=1e-5, rtol=0)
    own = mlp_init(torch.Generator().manual_seed(0), in_dim=in_dim, hidden=hidden)
    assert [tuple(a.shape) for a in tree_leaves(own)] == [tuple(a.shape) for a in tree_leaves(tp)]
    with pytest.raises(ValueError, match="not an MLP"):
        mlp_params_from_jax({"fc1": jp["fc1"]})


LRS = np.linspace(0.5, 1.5, WHOLE["n_nodes"]).astype(np.float32)
# AdamW's step m/(sqrt(v) + eps) turns a gradient of 1e-12 into a step of
# order lr where eps is small: an fp32 rounding of a near-zero gradient
# (0 in one engine, 1e-12 in the other) moves a parameter by ~lr.  With
# eps = 1e-3 the step is Lipschitz in g with a constant of ~1e3, and the
# whole run is continuous; the unit test above holds the default eps.
RUNS = {
    "adamw-lrs": dict(optimizer=("adamw", 0.01, dict(eps=1e-3, weight_decay=0.01)),
                      heterogeneous_lrs=LRS),
    "nesterov-lrs": dict(optimizer=("momentum", 0.02, dict(nesterov=True)),
                         heterogeneous_lrs=LRS),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def optim_run(request):
    kw = RUNS[request.param]
    return kw, jax_run(WHOLE, **kw)


def test_engine_with_optimizer_and_lrs_tracks_jax(optim_run):
    """Per-node learning-rate multipliers with AdamW and with Nesterov
    momentum through the whole engine from the JAX run's parameters.  The final
    optimizer state has the JAX engine's leaves and shapes (and AdamW's
    step counts); its values are raw gradient moments, and a max-pool tie
    (ROADMAP Queue 3) moves single gradient entries by more than 1e-4 while
    the parameters stay within it, so they are held through the
    parameters."""
    kw, want = optim_run
    eng, snaps = torch_run(WHOLE, want["init"], **kw)
    assert_whole_run_tracks(eng, snaps, want)
    assert_run_metrics_match(eng, want)
    got, ref = jax.tree_util.tree_leaves(eng.opt_state), jax.tree_util.tree_leaves(want["opt_state"])
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    if "t" in want["opt_state"]:
        np.testing.assert_array_equal(eng.opt_state["t"].numpy(), want["opt_state"]["t"])
