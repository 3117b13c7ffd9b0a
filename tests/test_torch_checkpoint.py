"""Port parity: checkpoints cross between the two packages, and resume
continues the run.

The engines here are ``tests/test_resume.py``'s: 8 nodes, 3-regular, the
MLP of hidden width 8 (smooth: no max-pool tie), plain SGD.  A checkpoint
the JAX engine writes after 4 rounds loads into the port's engine, whose
next 4 rounds end within 1e-5 of the JAX engine's uninterrupted 8; the
port's own checkpoint continues its run bitwise (the reference's resume
oracle), in the same process and across a restart; a port checkpoint
loads into the JAX engine; both write the same file format.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.core import DLConfig as JDLConfig
from repro.core import RoundEngine as JRoundEngine
from repro.utils.io import atomic_write_json as jatomic
from repro.utils.pytree import tree_vector as jtree_vector
from repro_torch import DLConfig, RoundEngine
from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, restore_tree, save_checkpoint
from repro_torch.utils.io import atomic_write_json


def _cfg(**kw):
    return {**dict(n_nodes=8, topology="regular", degree=3, rounds=8, eval_every=4, seed=11), **kw}


def _data(mod, seed=11):
    ds = mod.make_dataset("cifar10", n_train=256, n_test=64, seed=7, sigma=4.0)
    parts = mod.sharding_partition(ds.train_y, 8, 2, seed=seed)
    return ds, mod.NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=seed)


def jax_engine(**kw):
    import repro.data as jdata
    from repro.models.api import cross_entropy
    from repro.models.mlp import mlp_apply, mlp_init
    from repro.optim import make_optimizer

    _, batcher = _data(jdata)
    return JRoundEngine(JDLConfig(**_cfg(**kw)), lambda k: mlp_init(k, hidden=8),
                        lambda p, x, y: cross_entropy(mlp_apply(p, x), y),
                        lambda p, x, y: (mlp_apply(p, x).argmax(-1) == y).mean(),
                        make_optimizer("sgd", 0.05), batcher)


def torch_engine(optimizer=("sgd", 0.05, {}), **kw):
    import repro_torch.data as tdata
    from repro_torch.models.api import cross_entropy
    from repro_torch.models.mlp import mlp_apply, mlp_init
    from repro_torch.optim import make_optimizer

    _, batcher = _data(tdata)
    name, lr, okw = optimizer
    return RoundEngine(DLConfig(**_cfg(**kw)), lambda g: mlp_init(g, hidden=8),
                       lambda p, x, y: cross_entropy(mlp_apply(p, x), y),
                       lambda p, x, y: (mlp_apply(p, x).argmax(-1) == y).float().mean(),
                       make_optimizer(name, lr, **okw), batcher, device="cpu")


def _jX(eng):
    return np.asarray(jax.vmap(jtree_vector)(eng.params))


SHARING = {"full": {}, "topk": dict(sharing="topk", budget=0.25),
           "randomk": dict(sharing="randomk", budget=0.25)}


@pytest.mark.parametrize("name", ["full", "randomk"])
def test_jax_checkpoint_continues_the_jax_trajectory_in_the_port(tmp_path, name):
    """(TopK's state crosses the other way, below.)"""
    kw = SHARING[name]
    ref = jax_engine(**kw)
    ref.run(log=False)
    half = jax_engine(**kw)
    half.run(rounds=4, log=False)
    half.save_state(str(tmp_path))
    eng = torch_engine(**kw)
    assert eng.load_state(str(tmp_path)) == 4
    np.testing.assert_array_equal(eng.X.numpy(), _jX(half))
    eng.run(rounds=8, log=False)
    np.testing.assert_allclose(eng.X.numpy(), _jX(ref), atol=1e-5, rtol=0)
    assert [h["round"] for h in eng.history] == [4, 7]


def test_port_checkpoint_loads_into_the_jax_engine(tmp_path):
    """The other direction: the port's checkpoint after 4 rounds, restored
    by the JAX engine, holds the port's state bitwise."""
    eng = torch_engine(**SHARING["topk"])
    eng.run(rounds=4, log=False)
    eng.save_state(str(tmp_path))
    j = jax_engine(**SHARING["topk"])
    assert j.load_state(str(tmp_path)) == 4
    np.testing.assert_array_equal(_jX(j), eng.X.numpy())
    np.testing.assert_array_equal(np.asarray(j.share_state["last_shared"]),
                                  eng.share_state["last_shared"].numpy())


@pytest.mark.parametrize("case", ["full", "topk", "adamw-dynamic"])
def test_resume_continues_exactly(tmp_path, case):
    """4 rounds, checkpoint, a fresh engine, 4 more rounds: bitwise the 8
    uninterrupted rounds (TopK's state and AdamW's moments and counts
    included)."""
    kw = {"full": {}, "topk": SHARING["topk"],
          "adamw-dynamic": dict(optimizer=("adamw", 0.01, {}), topology="dynamic")}[case]
    ref = torch_engine(**kw)
    ref.run(log=False)
    half = torch_engine(**kw)
    half.run(rounds=4, log=False)
    half.save_state(str(tmp_path))
    fresh = torch_engine(**kw)
    assert fresh.load_state(str(tmp_path)) == 4
    fresh.run(rounds=8, log=False)
    np.testing.assert_array_equal(fresh.X.numpy(), ref.X.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(fresh.opt_state),
                    jax.tree_util.tree_leaves(ref.opt_state)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_resume_in_fresh_process(tmp_path):
    ref = torch_engine()
    ref.run(log=False)
    half = torch_engine()
    half.run(rounds=4, log=False)
    half.save_state(str(tmp_path / "ck"))
    out = tmp_path / "X.npy"
    # the restarted process imports the port alone (no JAX), as a user's would
    script = textwrap.dedent(f"""
        import numpy as np
        import repro_torch.data as tdata
        from repro_torch import DLConfig, RoundEngine
        from repro_torch.models.api import cross_entropy
        from repro_torch.models.mlp import mlp_apply, mlp_init
        from repro_torch.optim import make_optimizer
        ds = tdata.make_dataset("cifar10", n_train=256, n_test=64, seed=7, sigma=4.0)
        parts = tdata.sharding_partition(ds.train_y, 8, 2, seed=11)
        batcher = tdata.NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=11)
        eng = RoundEngine(DLConfig(**{_cfg()!r}), lambda g: mlp_init(g, hidden=8),
                          lambda p, x, y: cross_entropy(mlp_apply(p, x), y),
                          lambda p, x, y: (mlp_apply(p, x).argmax(-1) == y).float().mean(),
                          make_optimizer("sgd", 0.05), batcher, device="cpu")
        assert eng.load_state({str(tmp_path / 'ck')!r}) == 4
        eng.run(rounds=8, log=False)
        np.save({str(out)!r}, eng.X.numpy())
    """)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(out), ref.X.numpy())


def test_same_file_format_and_named_steps(tmp_path):
    """One tree written by each package: the same meta JSON and arrays;
    the latest step wins unless a step is named; a stray meta file or a
    missing directory is no checkpoint."""
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "a": (rng.integers(0, 9, (3,)).astype(np.int32), rng.normal(size=(2,)))}
    jsave(str(tmp_path / "j"), 3, params=tree)
    save_checkpoint(str(tmp_path / "t"), 3,
                    params=jax.tree_util.tree_map(torch.tensor, tree))
    with open(tmp_path / "j" / "ckpt_00000003.json") as f, \
            open(tmp_path / "t" / "ckpt_00000003.json") as g:
        assert json.load(f) == json.load(g)
    (_, jt), (_, tt) = jload(str(tmp_path / "j")), load_checkpoint(str(tmp_path / "t"))
    assert jax.tree_util.tree_structure(jt) == jax.tree_util.tree_structure(tt)
    for a, b in zip(jax.tree_util.tree_leaves(jt), jax.tree_util.tree_leaves(tt)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    like = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), tree)
    back = restore_tree(like, tt["params"])
    np.testing.assert_array_equal(back["a"][0].numpy(), tree["a"][0])
    assert back["a"][0].dtype == torch.int32 and restore_tree((), None) == ()
    save_checkpoint(str(tmp_path / "t"), 10, params=like)
    (tmp_path / "t" / "ckpt_00000020.json").write_text("{}")
    assert latest_checkpoint(str(tmp_path / "t")) == 10
    assert load_checkpoint(str(tmp_path / "t"), 3)[0] == 3
    assert latest_checkpoint(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_atomic_write_json_matches_the_reference(tmp_path):
    obj = {"round": 3, "acc": [0.5, 0.25], "name": "x"}
    jatomic(str(tmp_path / "j" / "r.json"), obj)
    atomic_write_json(str(tmp_path / "t" / "r.json"), obj)
    assert (tmp_path / "j" / "r.json").read_text() == (tmp_path / "t" / "r.json").read_text()
    assert not (tmp_path / "t" / "r.json.tmp").exists()
