"""Port parity of the LM trainer against the JAX package on the CPU: the
trainer's gossip (``mix_fully`` within 1e-7, ``mix_circulant`` within
1e-6), the token stream and its batcher bitwise, and the decentralized
train step, per-step losses and parameters within 1e-5, for SGD and
momentum over the fully connected and the 5-regular circulant overlays,
both started from the same injected JAX parameters and optimizer state.
Then the entry point alone: ``--chunk-steps`` leaves the losses bitwise, a
resumed run equals a straight one, its checkpoint loads in the JAX
package; the kernel-route refusal; the sharded mixings' refusal.

The reference's ``make_train_step`` is ``vmap(make_node_train_step)``,
then ``_gossip`` and the mean over nodes.  The module fixture jits the
reference's node step once per optimizer and applies the reference's
``_gossip`` to its output, so the two overlays share one compile (each
takes some 6-10 s); ``tests/test_torch_moe.py`` runs the jitted
``make_train_step`` itself.  SmolLM-135M's smoke config (2 layers,
d_model 192, window 16), N=8, batch 2, seq 32, 3 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from repro.checkpoint import load_checkpoint as jload
from repro.configs import get_smoke_config as jsmoke
from repro.core import mixing as jmix
from repro.data import datasets as jds
from repro.launch.train import build_lm_batcher as jbatcher
from repro.models import api as japi
from repro.optim import make_optimizer as jmake_opt
from repro.training import trainer as jtrainer
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import mixing as tmix
from repro_torch.data import datasets as tds
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.training import trainer as ttrainer
from repro_torch.utils.pytree import tree_leaves

ARCH, N, B, SEQ, STEPS, LR = "smollm-135m", 8, 2, 32, 3, 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _noisy_stack(tree, n, seed, scale=0.02):
    """A single-node tree stacked n times, each copy plus its own noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a)[None] + scale * rng.normal(size=(n,) + a.shape)).astype(a.dtype),
        tree)


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def ref():
    """The reference's trajectories: {(optimizer, topology): (start params,
    start state, per-step mean losses, final params)}, and the batches."""
    cfg = jsmoke(ARCH)
    base = jax.jit(lambda k: japi.init_params(cfg, k))(jax.random.key(0))
    params0 = _noisy_stack(base, N, 0)
    batch_fn = jbatcher(cfg, N, B, SEQ)
    batches = [_np(batch_fn(s)) for s in range(STEPS)]
    out = {}
    for name in ("sgd", "momentum"):
        opt = jmake_opt(name, LR)
        state0 = _np(jax.vmap(opt.init)(params0))
        if name == "momentum":
            state0 = _noisy_stack(jax.tree_util.tree_map(lambda a: a[0], state0), N, 1, 0.05)
        tc = jtrainer.TrainConfig(n_nodes=N, topology="regular", degree=5, grad_clip=1.0)
        node_step = jax.jit(jax.vmap(jtrainer.make_node_train_step(cfg, opt, tc)))
        for topo in ("fully", "regular"):
            tc = dataclasses.replace(tc, topology=topo)
            p, st, losses = params0, state0, []
            for b in batches:
                p, st, node_losses = node_step(p, st, jax.tree_util.tree_map(jnp.asarray, b))
                p = jtrainer._gossip(p, tc)
                losses.append(float(node_losses.mean()))
            out[(name, topo)] = (params0, state0, losses, _np(p))
    return out, batches


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------

def _stacked(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 7)).astype(np.float32)}}


def test_mix_fully_matches_jax():
    x = _stacked(8, 0)
    want = _np(jmix.mix_fully(jax.tree_util.tree_map(jnp.asarray, x)))
    got = tmix.mix_fully(params_from_jax(x))
    for g, w in zip(tree_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,degree", [(8, 2), (7, 2), (9, 4), (8, 4), (8, 5), (6, 5), (2, 2)])
@pytest.mark.parametrize("weighted", [False, True])
def test_mix_circulant_matches_jax(n, degree, weighted):
    """Ring (degree 2), degree 4, and degree 5 with its antipodal offset
    (one neighbour), at the default and at given [w_self, w_off...]."""
    x = _stacked(n, n + degree)
    n_off = len(jmix.circulant_offsets(n, degree))
    w = np.random.default_rng(3).uniform(0.1, 0.5, 1 + n_off).astype(np.float32) if weighted else None
    want = _np(jmix.mix_circulant(jax.tree_util.tree_map(jnp.asarray, x), n, degree,
                                  None if w is None else jnp.asarray(w)))
    got = tmix.mix_circulant(params_from_jax(x), n, degree,
                             None if w is None else torch.as_tensor(w))
    for g, ww in zip(tree_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.numpy(), ww, rtol=0, atol=1e-6)


def test_circulant_tables_are_built_once():
    a = tmix.circulant_tables(8, 5, torch.device("cpu"))
    assert tmix.circulant_tables(8, 5, torch.device("cpu")) is a
    rows, slot = a
    # node 0: self, +1, -1, +2, -2, the antipodal 4 once
    assert rows[0].tolist() == [0, 1, 7, 2, 6, 4] and slot.tolist() == [0, 1, 1, 2, 2, 3]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_train=32, n_test=8, seq_len=17, vocab=64),
                                dict(n_train=16, n_test=4, seq_len=9, vocab=512, seed=3)])
def test_synthetic_lm_bitwise(kw):
    a, b = jds.make_dataset("lm", **kw), tds.make_dataset("tokens", **kw)
    for f in ("train_x", "train_y", "test_x", "test_y", "trans"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("n,batch,seq,seed", [(8, 2, 32, 0), (5, 3, 16, 2)])
def test_lm_batcher_bitwise(n, batch, seq, seed):
    cfg = jsmoke(ARCH)
    jfn, tfn = jbatcher(cfg, n, batch, seq, seed=seed), tlaunch.build_lm_batcher(
        tsmoke(ARCH), n, batch, seq, seed=seed)
    for step in (0, 1, 7):
        want, got = jfn(step), tfn(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            assert got[k].dtype == np.asarray(want[k]).dtype


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name", ["sgd", "momentum"])
@pytest.mark.parametrize("topology", ["fully", "regular"])
def test_train_step_matches_jax(ref, opt_name, topology):
    trajs, batches = ref
    params0, state0, want_losses, want_params = trajs[(opt_name, topology)]
    tc = ttrainer.TrainConfig(n_nodes=N, topology=topology, degree=5, grad_clip=1.0)
    step = ttrainer.make_train_step(tsmoke(ARCH), tmake_opt(opt_name, LR), tc)
    params, state = params_from_jax(params0), opt_state_from_jax(state0)
    losses = []
    for b in batches:
        params, state, loss = step(params, state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(loss))
        assert len(ttrainer.flat_buffers(params)) == 1  # views of one (N, P) buffer
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    got = tree_leaves(params)
    want = _leaves(want_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_opt_state_from_jax_carries_every_optimizer():
    p = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    assert opt_state_from_jax(()) == ()
    adam = _np(jax.vmap(jmake_opt("adamw", 1e-3).init)(jax.tree_util.tree_map(jnp.asarray, p)))
    got = opt_state_from_jax(adam)
    assert got["t"].dtype == torch.int32 and tuple(got["t"].shape) == (2,)
    assert torch.equal(got["mu"]["w"], torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _args(tmp_path, **kw):
    argv = ["--device", "cpu", "--arch", ARCH, "--nodes", "4", "--batch", "2", "--seq", "16",
            "--steps", "3", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return tlaunch.parse_args(argv)


def test_chunk_steps_leave_losses_bitwise(tmp_path):
    one = tlaunch.train(_args(tmp_path / "a", chunk_steps=1))
    eight = tlaunch.train(_args(tmp_path / "b", chunk_steps=8))
    assert one["losses"] == eight["losses"] and len(one["losses"]) == 3
    assert np.isfinite(one["losses"]).all()
    for a, b in zip(tree_leaves(one["trainer"].params), tree_leaves(eight["trainer"].params)):
        assert torch.equal(a, b)


def test_resume_equals_a_straight_run_and_loads_in_jax(tmp_path):
    straight = tlaunch.train(_args(tmp_path / "s", steps=4, degree=2, chunk_steps=3))
    tlaunch.train(_args(tmp_path / "r", steps=2, degree=2))
    resumed = tlaunch.train(_args(tmp_path / "r", steps=4, degree=2, resume=True))
    assert resumed["losses"] == straight["losses"][2:]
    for a, b in zip(tree_leaves(resumed["trainer"].params), tree_leaves(straight["trainer"].params)):
        assert torch.equal(a, b)
    step, trees = jload(str(tmp_path / "r" / "ck"))
    assert step == 4
    want = tree_leaves(resumed["trainer"].params)
    got = jax.tree_util.tree_leaves(trees["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    hist = (tmp_path / "r" / "ck" / "history.json").read_text()
    assert '"step": 3' in hist


def test_launch_rules_as_the_reference(tmp_path):
    tr = tlaunch.LMTrainer(_args(tmp_path, nodes=4, degree=5))
    assert tr.topology == "fully" and tr.cfg.dtype == "float32"
    assert tlaunch.LMTrainer(_args(tmp_path, nodes=6, degree=2)).topology == "regular"
    with pytest.raises(SystemExit):
        tlaunch.LMTrainer(_args(tmp_path, arch="gn-lenet"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.LMTrainer(tlaunch.parse_args(["--arch", ARCH]))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _one_step(cfg, seq, jax_too=False):
    """One SGD train step of ``cfg`` (a JAX config) on two nodes, fully
    connected, from the port's seeded init plus per-node noise, in the port
    (and first in the reference with ``jax_too``); returns the port's
    (params, state, loss)."""
    n = 2
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (n, 1, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    tcfg = TConfig(**dataclasses.asdict(cfg))
    base = tapi.init_params(tcfg, torch.Generator().manual_seed(0))
    params = _noisy_stack(jax.tree_util.tree_map(lambda a: a.numpy(), base), n, 0)
    if jax_too:
        jstep = jtrainer.make_train_step(cfg, jmake_opt("sgd", LR),
                                         jtrainer.TrainConfig(n_nodes=n, topology="fully"))
        jstep(jax.tree_util.tree_map(jnp.asarray, params), (),
              jax.tree_util.tree_map(jnp.asarray, b))
    tstep = ttrainer.make_train_step(tcfg, tmake_opt("sgd", LR),
                                     ttrainer.TrainConfig(n_nodes=n, topology="fully"))
    return tstep(params_from_jax(params), (), {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("arch,over,seq", [
    ("smollm-135m", dict(attn_impl="pallas_swa", sliding_window=128), 128),
    ("mamba2-370m", dict(ssm_impl="pallas"), 32),
])
def test_kernel_routes_refused_where_the_reference_fails(arch, over, seq):
    cfg = jsmoke(arch).replace(**over)
    with pytest.raises(Exception):
        _one_step(cfg, seq, jax_too=True)
    with pytest.raises(NotImplementedError, match="cannot differentiate its Pallas kernels"):
        _one_step(cfg, seq)


@pytest.mark.parametrize("window,seq", [(16, 32), (128, 32)])
def test_trains_where_the_reference_stays_off_its_kernel(window, seq):
    """The smoke window 16 is off the kernel's 128-key tiles, and 32
    positions are off its 128-query tiles: the step trains, bitwise as the
    plain route at the same window."""
    cfg = jsmoke(ARCH).replace(sliding_window=window)
    want = _one_step(cfg, seq)
    got = _one_step(cfg.replace(attn_impl="pallas_swa"), seq)
    assert float(got[2]) == float(want[2]) and np.isfinite(float(got[2]))
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["shard_map", "sparse", "quant", "sparse+quant"])
def test_sharded_mixings_raise_and_cite_item_6(impl):
    """The sharded mixings (ported with ROADMAP Queue 1 item 6) run one
    node per rank of a process group; outside one they raise and name
    the launcher (``tests/test_torch_shard_trainer.py`` runs them)."""
    tc = ttrainer.TrainConfig(n_nodes=4, topology="regular", degree=2, mixing_impl=impl)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ttrainer._gossip(torch.zeros(1, 3), tc)
    with pytest.raises(RuntimeError, match="launch.shard.run"):
        ttrainer.make_train_step(tsmoke(ARCH), tmake_opt("sgd", LR), tc)
