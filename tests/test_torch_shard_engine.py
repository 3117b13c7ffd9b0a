"""The node-sharded RoundEngine on S=4 gloo ranks of the CPU, held against
the port's single-device engine for every scenario of the JAX package's
``TestShardedEngine`` (``tests/test_sharded_engine.py``), at its
configuration: the consensus model over 16 parameters, 16 nodes, 8
rounds, evaluations at rounds 0, 4 and 7.

* backends 'gather' (the all-gather) and 'ppermute' (the
  slot-permutation exchange, merging in the table's own slot order) are
  bitwise the single-device run: parameters, every history record, bytes
  and simulated time (the reference holds its ppermute runs only within
  rtol 2e-5 / atol 1e-6, as it merges in the rebalanced slot order);
* the reference's sharding rules raise ``ValueError`` where its own do;
* a checkpoint saved by the ranks resumes bitwise and loads in the
  single-device engine;
* one full-sharing ppermute run against the JAX package's sharded engine
  (8 devices of ``--xla_force_host_platform_device_count=8``, run in a
  subprocess) within 1e-5, from the JAX run's initial parameters;
* ``python -m repro_torch.quickstart --shard-devices 4`` runs and equals
  the single-device quickstart.

One spawn of the ranks (a module fixture) runs every case.
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_shard_ranks as ranks
from repro.core import DLConfig as JDLConfig
from repro.core import FaultPlan as JFaultPlan
from repro_torch import DLConfig, FaultPlan
from repro_torch.launch import shard

S, ROUNDS = 4, 8
R5 = dict(topology="regular", degree=5)
CASES = {
    "sparse_static_gather": dict(R5),
    "sparse_static_ppermute": dict(R5, shard_backend="ppermute"),
    "dynamic_sparse": dict(topology="dynamic", degree=5),
    "dense_fully": dict(topology="fully"),
    "churn": dict(R5, participation=0.6),
    "churn_network_time": dict(R5, participation=0.6, network="lan"),
    "secure": dict(R5, secure=True),
    "secure_ppermute": dict(R5, secure=True, shard_backend="ppermute"),
    "secure_churn_recovery": dict(R5, secure=True, participation=0.6, secure_recovery=True),
    "secure_churn_recovery_machine_correlated": dict(
        R5, secure=True, participation=0.6, churn_machines=4, secure_recovery=True),
    "randomk_per_node_keys": dict(R5, sharing="randomk"),
    "choco": dict(R5, sharing="choco"),
    "payload_randomk": dict(R5, sharing="randomk", payload="on"),
    "payload_randomk_strided_ppermute": dict(R5, sharing="randomk", randk_sampler="strided",
                                             payload="on", shard_backend="ppermute"),
    "payload_topk_ppermute": dict(R5, sharing="topk", payload="on", shard_backend="ppermute"),
    "payload_topk_dynamic": dict(topology="dynamic", degree=5, sharing="topk", payload="on"),
    "payload_churn": dict(R5, sharing="randomk", payload="on", participation=0.6),
    "payload_choco": dict(R5, sharing="choco", payload="on"),
    "payload_quant_ppermute": dict(R5, sharing="topk", payload="on", payload_quant=True,
                                   shard_backend="ppermute"),
    "payload_topk_churn_ppermute": dict(R5, sharing="topk", payload="on", participation=0.6,
                                        shard_backend="ppermute"),
    "payload_strided_dynamic_churn": dict(topology="dynamic", degree=5, sharing="randomk",
                                          randk_sampler="strided", payload="on",
                                          participation=0.6),
    "heterogeneous_compute_time": dict(R5, network="lan", compute_time_s=0.01,
                                       straggler_factor=10.0, straggler_frac=0.25),
    "machine_correlated_churn": dict(R5, participation=0.6, churn_machines=4),
    "quantized_sharing_ppermute": dict(R5, sharing="quant", shard_backend="ppermute"),
    "secure_churn_recovery_ppermute": dict(R5, secure=True, participation=0.6,
                                           secure_recovery=True, shard_backend="ppermute"),
}
# rejected where the engine is built: the ppermute schedule needs a static
# sparse table (the reference's test_ppermute_needs_static_sparse)
BUILD_REJECTED = {
    "ppermute_dynamic": (dict(topology="dynamic", degree=5, shard_backend="ppermute"),
                         "static sparse"),
    "ppermute_dense": (dict(topology="fully", shard_backend="ppermute"), "static sparse"),
}
# rejected by DLConfig.validate, in both packages (the reference's rules)
VALIDATE_REJECTED = [
    (dict(R5, shard_devices=8, semantics="async"), None, "single-host"),
    (dict(R5, shard_devices=8, semantics="local"), None, "single-host"),
    (dict(R5, n_nodes=12, shard_devices=8), None, "divide evenly"),
    (dict(R5, shard_devices=8, chunk_rounds=0), None, "chunk_rounds"),
    (dict(R5, shard_devices=4), dict(msg_loss=0.1), "single-host"),
    (dict(R5, shard_devices=4, batch_keying="node"), None, "single-host"),
    (dict(R5, shard_devices=4, backend="processes"), None, "processes"),
]
JAX_CASE = dict(R5, shard_backend="ppermute")

JAX_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import test_sharded_engine as t
    kw = dict(topology="regular", degree=5, shard_backend="ppermute")
    eng = t._engine(shard_devices=8, **kw)
    init = np.asarray(eng.params["w"])
    eng.run(rounds=8, log=False)
    np.savez(sys.argv[1], init=init, final=np.asarray(eng.params["w"]),
             acc=np.asarray([h["acc_mean"] for h in eng.history]),
             bytes=np.asarray(eng.bytes_sent))
""")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The single-device runs take one torch thread, as each rank does:
    the CPU's reduction order may follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single(kw, init=None):
    eng = ranks.consensus_engine("cpu", init_params=init, **kw)
    eng.run(rounds=ROUNDS, log=False)
    return ranks.engine_summary(eng)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded") / "run.npz"
    r = subprocess.run([sys.executable, "-c", JAX_SHARDED, str(out)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


@pytest.fixture(scope="module")
def sharded(jax_sharded, tmp_path_factory):
    cases = {**CASES, **{k: kw for k, (kw, _) in BUILD_REJECTED.items()},
             "jax_init": dict(JAX_CASE, init_params={"w": jax_sharded["init"]})}
    ckpt = tmp_path_factory.mktemp("sharded_ckpt")
    out = shard.run(ranks.engine_cases, S, cases, ROUNDS, str(ckpt), device="cpu",
                    timeout=300)
    out["ckpt_dir"] = str(ckpt)
    return out


def _assert_runs_equal(got, want):
    assert len(got["history"]) == len(want["history"]) == 3
    for k in ("share_stage_bytes", "topo_stage_bytes_peak", "wire_dtype"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["X"], want["X"])
    assert got["bytes_sent"] == want["bytes_sent"]
    assert got["sim_time_s"] == want["sim_time_s"]
    for h, w in zip(got["history"], want["history"]):
        assert {k: v for k, v in h.items() if k != "wall_s"} == \
            {k: v for k, v in w.items() if k != "wall_s"}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_single_device(sharded, name):
    got = sharded[name]
    ppermute = CASES[name].get("shard_backend") == "ppermute"
    assert got["backend"] == ("ppermute" if ppermute else "gather")  # 'auto' on gloo: gather
    _assert_runs_equal(got, _single(CASES[name]))


@pytest.mark.parametrize("name", list(BUILD_REJECTED))
def test_ppermute_needs_static_sparse(sharded, name):
    kind, msg = sharded[name]
    assert kind == "ValueError" and BUILD_REJECTED[name][1] in msg


@pytest.mark.parametrize("knob,plan,msg", VALIDATE_REJECTED)
def test_sharding_rules_raise_as_the_references(knob, plan, msg):
    for cfg_cls, plan_cls in ((JDLConfig, JFaultPlan), (DLConfig, FaultPlan)):
        cfg = cfg_cls(**knob, **({} if plan is None else {"faults": plan_cls(**plan)}))
        with pytest.raises(ValueError, match=msg):
            cfg.validate()


def test_engine_without_a_group_points_to_the_launcher():
    with pytest.raises(RuntimeError, match="launch.shard.run"):
        ranks.consensus_engine("cpu", shard_devices=4, **R5)


def test_checkpoint_resumes_bitwise_and_loads_on_one_device(sharded):
    resumed = sharded["resumed"]
    assert resumed["step"] == 4 and resumed["path"].endswith("ckpt_00000004.npz")
    straight = sharded["payload_topk_ppermute"]
    np.testing.assert_array_equal(resumed["X"], straight["X"])
    assert resumed["bytes_sent"] == pytest.approx(straight["bytes_sent"] / 2)
    # the file is the single-device engine's: one device continues the run
    kw = dict(R5, sharing="topk", payload="on")
    eng = ranks.consensus_engine("cpu", **kw)
    assert eng.load_state(sharded["ckpt_dir"]) == 4
    eng.run(rounds=ROUNDS, log=False)
    np.testing.assert_array_equal(eng.X.numpy(), straight["X"])


def test_ppermute_matches_the_jax_sharded_engine(sharded, jax_sharded):
    got = sharded["jax_init"]
    np.testing.assert_allclose(got["X"], jax_sharded["final"], rtol=0, atol=1e-5)
    np.testing.assert_allclose([h["acc_mean"] for h in got["history"]], jax_sharded["acc"],
                               rtol=0, atol=1e-5)
    assert got["bytes_sent"] == pytest.approx(float(jax_sharded["bytes"]), rel=1e-6)


def test_quickstart_shard_devices(tmp_path):
    """The sharded quickstart (GN-LeNet) equals the single-device one (one
    torch thread, as each rank: the CPU convolutions' reduction order
    follows the thread count)."""
    from repro_torch.quickstart import main

    argv = ["--rounds", "2", "--nodes", "8", "--chunk", "1", "--device", "cpu"]
    hist = main(argv + ["--shard-devices", "4", "--results-dir", str(tmp_path / "s")])
    eng = main(argv + ["--results-dir", str(tmp_path / "one")])
    assert [h["acc_mean"] for h in hist] == [h["acc_mean"] for h in eng.history]
    assert [h["bytes_per_node"] for h in hist] == [h["bytes_per_node"] for h in eng.history]
    assert (tmp_path / "s" / "results.json").exists()
