"""The port's twins of ``examples/topologies_dynamic.py``,
``examples/sparsification.py``, ``examples/faults.py``,
``examples/churn.py`` and ``examples/fl_vs_dl.py`` run on the CPU at 4
nodes and 2 rounds, through ``DecentralizedRunner`` (and
``FederatedRunner``), and give what a ``RoundEngine`` with the same
settings gives; the churn twin also under the local and async
schedulers; the process backend still raises."""
import math

import pytest

from repro_torch import churn, faults, fl_vs_dl, sparsification, topologies_dynamic
from repro_torch.core import DecentralizedRunner, DLConfig


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


def test_process_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        DecentralizedRunner(DLConfig(backend="processes"))
