"""The port's twins of ``examples/topologies_dynamic.py`` and
``examples/sparsification.py`` run on the CPU at 4 nodes and 2 rounds,
through ``DecentralizedRunner``, and give what a ``RoundEngine`` with the
same settings gives; the process backend still raises."""
import math

import pytest

from repro_torch import sparsification, topologies_dynamic
from repro_torch.core import DecentralizedRunner, DLConfig


@pytest.mark.parametrize("mod,names", [
    (topologies_dynamic, ["ring", "regular", "fully", "dynamic"]),
    (sparsification, ["full", "randomk", "topk", "choco"]),
])
def test_entry_point_runs_on_the_cpu(mod, names, capsys):
    out = mod.main(["--device", "cpu", "--nodes", "4", "--rounds", "2"])
    assert list(out) == names
    for acc, sent in out.values():
        assert 0.0 <= acc <= 1.0 and math.isfinite(acc) and sent > 0
    text = capsys.readouterr().out
    assert all(name in text for name in names)
    if mod is sparsification:  # a 10% budget sends far less than full sharing
        assert out["randomk"][1] < 0.25 * out["full"][1]


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
