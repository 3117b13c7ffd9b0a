"""A whole run of each cell at a CPU size (``run.execute``: set-up,
window, check; the look for a card skipped), sound and with the timed
path broken underneath, and the TF32 control: ``correct`` holds for the
sound program and comes out false for every fault the cell can have.
Without a card, a run prints no result."""
import contextlib

import pytest
import torch

from portbench import check, control, run, tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]


@contextlib.contextmanager
def broken(fault: str, driver: str):
    """The program with one fault planted where the timed path computes."""
    import repro_torch.core.engine as engine
    import repro_torch.core.scheduler as scheduler
    import repro_torch.core.secure as secure
    import repro_torch.core.sharing as sharing
    import repro_torch.core.steps as steps
    import repro_torch.launch.train as train
    import repro_torch.training.trainer as trainer

    mp = pytest.MonkeyPatch()
    if fault == "unchanged" and driver == "engine":
        orig = steps.RoundSteps.train_and_mix

        def same(self, X, *a, **kw):
            before = X.clone()
            out = orig(self, X, *a, **kw)
            return (before,) + tuple(out[1:])
        mp.setattr(steps.RoundSteps, "train_and_mix", same)
    elif fault == "unchanged":
        orig = train.LMTrainer.run_chunk

        def same(self, step, r):
            before = {k: v.clone() for k, v in common_leaves(self.params)}
            out = orig(self, step, r)
            for k, v in common_leaves(self.params):
                v.copy_(before[k])
            return out
        mp.setattr(train.LMTrainer, "run_chunk", same)
    elif fault == "half_batch" and driver == "engine":
        orig = scheduler.Scheduler._batch
        mp.setattr(scheduler.Scheduler, "_batch",
                   lambda self, idx: orig(self, idx[..., :idx.shape[-1] // 2]))
    elif fault == "half_batch":
        orig = train.LMTrainer.batches
        mp.setattr(train.LMTrainer, "batches", lambda self, step, r: {
            k: v[:, :, :v.shape[2] // 2] for k, v in orig(self, step, r).items()})
    elif fault == "no_exchange" and driver == "engine":
        mp.setattr(sharing.FullSharing, "round",
                   lambda self, X, W, state, key=None, degree=1.0, rnd=0:
                   (X.clone(), state, degree * X.shape[1] * X.element_size()))
        mp.setattr(sharing.RandomKSharing, "round",
                   lambda self, X, W, state, key=None, degree=1.0, rnd=0:
                   (X.clone(), state, self._nbytes(degree, self._k(X), 4, 0)))
        mp.setattr(secure.SecureAggregation, "round",
                   lambda self, X, W, state, key, degree, rnd=0, act=None:
                   (X.clone(), state, secure.wire_bytes(degree, X.shape[1], 4)))
    elif fault == "no_exchange":
        mp.setattr(trainer, "_gossip", lambda params, tc, W=None, shard=None: params.clone())
    elif fault == "answer" and driver == "engine":
        orig = engine.RoundEngine._eval

        def altered(self, tx, ty):
            accs = orig(self, tx, ty)
            accs[0] = 1.0 - accs[0]
            return accs
        mp.setattr(engine.RoundEngine, "_eval", altered)
    else:  # one node's loss where the step produces it
        orig = trainer.make_node_train_step

        def make(*a, **kw):
            step = orig(*a, **kw)

            def altered(params, opt_state, batch):
                params, opt_state, losses = step(params, opt_state, batch)
                return params, opt_state, torch.cat([losses[1:2], losses[1:]])
            return altered
        mp.setattr(trainer, "make_node_train_step", make)
    try:
        yield
    finally:
        mp.undo()


def common_leaves(tree):
    from portbench.inputs import leaf_items
    return leaf_items(tree)


def _execute(name):
    cfg, traffic, limits, metrics = tiny.cell(name)
    result, numbers = run.execute(cfg, traffic, limits, metrics, 2 ** 40 + 3, 0.0, False, "cpu")
    return result, numbers, cfg


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, numbers, _ = _execute(name)
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"rounds_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange", "answer"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault):
    cfg = tiny.cell(name)[0]
    with broken(fault, cfg["driver"]):
        result, numbers, _ = _execute(name)
    assert not result["correct"], numbers


def test_no_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the run would measure")
    assert run.main(["--workload", CELLS[0], "--seed", str(2 ** 40), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
    cfg, traffic, limits, _ = tiny.cell(name)
    numbers = control.readings(cfg, traffic, limits, 7, "cpu", faults=False)["tf32"]
    assert not check.passed(numbers), numbers
