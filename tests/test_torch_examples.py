"""The port's twins of ``examples/topologies_dynamic.py``,
``examples/sparsification.py``, ``examples/faults.py``,
``examples/churn.py`` and ``examples/fl_vs_dl.py`` run on the CPU at 4
nodes and 2 rounds, through ``DecentralizedRunner`` (and
``FederatedRunner``), and give what a ``RoundEngine`` with the same
settings gives; the churn twin also under the local and async
schedulers.  The twins of ``examples/secure_aggregation.py`` (against
the reference's byte overhead and masks on the CPU) and
``examples/processes.py`` (the kill demo, 2 worker processes) too."""
import functools
import math

import pytest

from repro_torch import (churn, faults, fl_vs_dl, processes, secure_aggregation,
                         sparsification, topologies_dynamic)
from repro_torch.core import DecentralizedRunner, DLConfig
from repro_torch.runtime import ProcessRunner


@pytest.mark.parametrize("mod,names,printed", [
    (topologies_dynamic, ["ring", "regular", "fully", "dynamic"], None),
    (sparsification, ["full", "randomk", "topk", "choco"], None),
    (faults, [f"msg_loss={p}" for p in (0.0, 0.05, 0.1, 0.2)], "injected"),
    (churn, [f"participation={p}" for p in (1.0, 0.9, 0.7, 0.5)], "participation"),
    (fl_vs_dl, ["fedavg", "d-psgd"], "FedAvg"),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_entry_point_runs_on_the_cpu(mod, names, printed, capsys):
    out = mod.main(["--device", "cpu", "--nodes", "4", "--rounds", "2"])
    assert list(out) == names
    for acc, sent in out.values():
        assert 0.0 <= acc <= 1.0 and math.isfinite(acc) and sent > 0
    text = capsys.readouterr().out
    assert all(name in text for name in (names if printed is None else [printed]))
    if mod is sparsification:  # a 10% budget sends far less than full sharing
        assert out["randomk"][1] < 0.25 * out["full"][1]
    if mod is churn:  # a down node sends nothing
        assert out["participation=0.5"][1] < out["participation=1.0"][1]


def test_faults_twin_counts_what_it_injects(capsys):
    """Corruption and a crash window: the printed counters conserve
    (injected == detected + survived) and every detection rolls back."""
    faults.main(["--device", "cpu", "--nodes", "4", "--rounds", "3", "--corrupt", "0.3",
                 "--crash", "1:0:2"])
    rows = [line.split() for line in capsys.readouterr().out.splitlines()[1:]]
    assert len(rows) == 4
    for _, _, _, inj, det, surv, rec, _ in rows:
        assert int(inj) == int(det) + int(surv) and int(det) == int(rec)
        assert int(surv) >= 2  # node 1 down in rounds 0 and 1


@pytest.mark.parametrize("semantics", ["local", "async"])
def test_churn_twin_runs_the_scheduler_semantics(semantics, capsys):
    """``--semantics local|async`` with stragglers: the clock column is
    printed (and staleness under async), and every setting trains."""
    out = churn.main(["--device", "cpu", "--nodes", "4", "--rounds", "2", "--semantics",
                      semantics, "--straggler-factor", "10", "--straggler-frac", "0.25"])
    assert list(out) == [f"participation={p}" for p in (1.0, 0.9, 0.7, 0.5)]
    for acc, sent in out.values():
        assert 0.0 <= acc <= 1.0 and sent > 0
    text = capsys.readouterr().out
    assert "median node clock" in text
    assert ("staleness" in text) == (semantics == "async")


def test_runner_wraps_the_engine():
    import repro_torch.data as tdata
    from repro_torch.models.mlp import mlp_init
    from repro_torch.optim import make_optimizer

    ds = tdata.make_dataset("cifar10", n_train=256, n_test=64)
    parts = tdata.sharding_partition(ds.train_y, 4, 2, seed=0)
    batcher = tdata.NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)
    dl = DLConfig(n_nodes=4, topology="dynamic", degree=3, rounds=2, eval_every=1)
    r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=16), topologies_dynamic.loss_fn,
                            topologies_dynamic.acc_fn, make_optimizer("sgd", 0.05), batcher,
                            device="cpu")
    hist = r.run(log=False)
    assert r.engine.sampler is not None and r.graph is None
    assert len(hist) == 2 and r.history is hist and r.bytes_sent == 2 * 3 * r.n_params * 4
    assert r.params["fc1"]["w"].shape == (4, 3072, 16) and r.share_state == ()


def test_secure_aggregation_twin_against_jax(capsys, monkeypatch):
    """The secure-aggregation twin: the secure run costs the reference's
    byte overhead over D-PSGD (its printed line, from the reference's own
    byte counts), the masked message on the same models is as far from
    its sender's as the reference's and the masked aggregate is the
    plain MH aggregate.  The twin's MLP is narrowed to hidden 4 here: on
    the CPU the masks are the plain Threefry in torch ops, which at the
    twin's width 128 takes minutes on a loaded host; the overhead does
    not depend on the width."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import DLConfig as JDLConfig
    from repro.core import SecureAggregation as JSecureAggregation
    from repro.core import build_graph as jbuild_graph
    from repro.core.sharing import FullSharing as JFullSharing
    from repro_torch.models.mlp import mlp_init

    monkeypatch.setattr(secure_aggregation, "mlp_init",
                        lambda g, hidden: mlp_init(g, hidden=4))
    out = secure_aggregation.main(["--device", "cpu", "--rounds", "1", "--nodes", "8"])
    assert list(out) == ["d-psgd", "secure-agg"]
    text = capsys.readouterr().out
    X = np.random.default_rng(0).standard_normal((8, 1000)).astype(np.float32)
    g = jbuild_graph(JDLConfig(n_nodes=8, topology="regular", degree=4))
    W = jnp.asarray(g.metropolis_hastings(), jnp.float32)
    s = JSecureAggregation(g.adj, mask_bound=5.0)
    agg, _, sec_bytes = s.round(jnp.asarray(X), W, (), jax.random.key(1), degree=4.0, rnd=0)
    _, _, full_bytes = JFullSharing().round(jnp.asarray(X), W, (), None, degree=4.0)
    want = f"communication overhead: {float(sec_bytes) / float(full_bytes) - 1:.1%}"
    assert want in text and want.endswith("3.0%")
    assert out["secure-agg"][1] / out["d-psgd"][1] - 1 == \
        pytest.approx(float(sec_bytes) / float(full_bytes) - 1, rel=1e-6)
    (i, _), m = next(iter(s.messages(jnp.asarray(X), jax.random.key(1), 0).items()))
    jrel = float(jnp.linalg.norm(m - X[i]) / jnp.linalg.norm(X[i]))
    jerr = float(jnp.max(jnp.abs(agg - W @ X)))
    rel, err = secure_aggregation.masked_demo(X, "cpu")
    # the port's masks are the mask kernel's counter-layout bits, the
    # reference's messages jax 0.9's ``jax.random.bits`` (a kept
    # difference): the same distribution, so the same distance to a few %
    assert rel == pytest.approx(jrel, rel=0.1) and rel > 1.0
    assert err < 1e-5 and jerr < 1e-5
    assert f"{rel:.1f}x norm (unreadable)" in text and "(masks cancel)" in text


def test_processes_twin_kill_demo(capsys, monkeypatch):
    """The process-backend twin's kill demo: the killed worker's rows are
    reweighted away and the survivors finish every round.  The runner gets
    the chaos tests' timeouts (a 6 s silence declares death, a send may
    wait 60 s), so a survivor starved by a loaded host is not taken for
    dead."""
    monkeypatch.setattr(processes, "ProcessRunner", functools.partial(
        ProcessRunner, dead_timeout_s=6.0, send_timeout_s=60.0))
    runner = processes.main(["--device", "cpu", "--nodes", "8", "--workers", "2",
                             "--rounds", "6", "--kill-worker", "1", "--kill-at-round", "2"])
    assert runner.counters["faults_detected"] >= 1 and int(runner.live_rows.sum()) == 4
    assert runner.history[-1]["round"] == 5
    text = capsys.readouterr().out
    assert "final consensus error" in text and "killed worker 1" in text
