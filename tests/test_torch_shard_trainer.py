"""The LM trainer's sharded mixings on S=4 gloo ranks of the CPU, one node
per rank: ``mixing_impl`` 'shard_map', 'sparse', 'quant' and
'sparse+quant' over the 4-node circulant of degree 3 (offset 1 both ways,
the antipodal offset 2 once), SmolLM-135M's smoke config, batch 2, seq
32, SGD, 2 steps, from the same noisy node-stacked parameters.

Each is held within 1e-5 (losses and parameters; for the int8 modes
apart from the code flips that ``test_sharded_step_matches_jax`` bounds)
against the JAX package's trainer step with the same mixing on a
4-device mesh of ``--xla_force_host_platform_device_count=8`` (its
``vmap``'d node step and its ``_gossip`` under ``shard_map``, run once in
a subprocess), and 'shard_map' also against the port's single-process
'roll' step.
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

import _torch_shard_ranks as ranks
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import shard
from repro_torch.optim import make_optimizer
from repro_torch.training import trainer
from repro_torch.utils.pytree import tree_leaves

ARCH, N, B, SEQ, STEPS, LR, DEGREE, BUDGET = "smollm-135m", 4, 2, 32, 2, 3e-2, 3, 0.3
MODES = ("shard_map", "sparse", "quant", "sparse+quant")

JAX_TRAINER = textwrap.dedent(f"""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.train import build_lm_batcher
    from repro.models import api
    from repro.optim import make_optimizer
    from repro.training import trainer
    tm = jax.tree_util.tree_map
    N, B, SEQ, STEPS, LR = {N}, {B}, {SEQ}, {STEPS}, {LR}
    cfg = get_smoke_config("{ARCH}")
    base = jax.jit(lambda k: api.init_params(cfg, k))(jax.random.key(0))
    rng = np.random.default_rng(0)
    params0 = tm(lambda a: (np.asarray(a)[None]
                            + 0.02 * rng.normal(size=(N,) + a.shape)).astype(a.dtype), base)
    batch_fn = build_lm_batcher(cfg, N, B, SEQ)
    batches = [tm(np.asarray, batch_fn(s)) for s in range(STEPS)]
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("data",))
    opt = make_optimizer("sgd", LR)
    tc0 = trainer.TrainConfig(n_nodes=N, topology="regular", degree={DEGREE}, grad_clip=1.0,
                              budget={BUDGET})
    node_step = jax.jit(jax.vmap(trainer.make_node_train_step(cfg, opt, tc0)))
    specs = tm(lambda a: P("data", *((None,) * (a.ndim - 1))), params0)
    runs = {{}}
    for mode in {MODES!r}:
        tc = dataclasses.replace(tc0, mixing_impl=mode)
        gossip = jax.jit(lambda p: trainer._gossip(p, tc, mesh=mesh, node_axes=("data",),
                                                   pspecs=specs))
        p, st, losses = params0, jax.vmap(opt.init)(params0), []
        for b in batches:
            p, st, node_losses = node_step(p, st, tm(jax.numpy.asarray, b))
            p = gossip(p)
            losses.append(float(node_losses.mean()))
        runs[mode] = (losses, tm(np.asarray, p))
    np.savez(sys.argv[1], out=np.asarray(dict(params0=params0, batches=batches, runs=runs),
                                         dtype=object))
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_trainer") / "runs.npz"
    r = subprocess.run([sys.executable, "-c", JAX_TRAINER, str(out)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return np.load(out, allow_pickle=True)["out"].item()


@pytest.fixture(scope="module")
def sharded(jax_runs):
    case = dict(arch=ARCH, n=N, modes=MODES, topology="regular", degree=DEGREE, budget=BUDGET,
                lr=LR, params=jax_runs["params0"], batches=jax_runs["batches"])
    return shard.run(ranks.trainer_cases, N, case, device="cpu", timeout=300)


def _flat(tree):
    return [np.asarray(torch.as_tensor(l)) for l in tree_leaves(params_from_jax(tree))]


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_matches_jax(sharded, jax_runs, mode):
    """Within 1e-5.  The int8 modes round x / scale to the nearest code,
    and after the first step the two packages' parameters differ by fp32
    rounding, so a value that sits at a rounding boundary may take the
    next code in one package: there the merged value moves by one
    neighbour weight times one code step (w · max|x| / 127), on at most
    1e-4 of the elements."""
    losses, params = sharded[mode]
    want_losses, want_params = jax_runs["runs"][mode]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
    w_nbr = 1.0 / (DEGREE + 1)
    for g, w in zip(_flat(params), _flat(want_params)):
        if "quant" not in mode:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            continue
        err = np.abs(g - w)
        flips = err > 1e-5
        assert flips.mean() <= 1e-4, flips.mean()
        assert err.max() <= 1e-5 + w_nbr * np.abs(w).max() / 127 * 1.01


def test_shard_map_equals_the_single_process_roll_step(sharded, jax_runs):
    cfg = get_smoke_config(ARCH)
    opt = make_optimizer("sgd", LR)
    tc = trainer.TrainConfig(n_nodes=N, topology="regular", degree=DEGREE, grad_clip=1.0)
    step = trainer.make_train_step(cfg, opt, tc)
    params = params_from_jax(jax_runs["params0"])
    state, losses = opt.init(params), []
    for b in jax_runs["batches"]:
        params, state, loss = step(params, state, params_from_jax(b))
        losses.append(float(loss))
    got_losses, got = sharded["shard_map"]
    np.testing.assert_allclose(got_losses, losses, rtol=0, atol=1e-5)
    for g, w in zip(_flat(got), [l.numpy() for l in tree_leaves(params)]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_sharded_mixing_needs_a_process_group():
    tc = trainer.TrainConfig(n_nodes=8, mixing_impl="quant")
    with pytest.raises(RuntimeError, match="launch.shard.run"):
        trainer.make_train_step(get_smoke_config(ARCH), make_optimizer("sgd", LR), tc)
