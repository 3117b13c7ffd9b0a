"""Equivalence oracles of the port's process backend on the CPU: K=4 real
worker processes gossiping over localhost TCP, N=16 nodes, the workload
of ``tests/test_runtime.py`` (the MLP at width 1).

- Full sharing: the process run equals the port's simulator bitwise (the
  workers draw each node's parameters by its global id), and from the
  JAX package's initial parameters it equals the JAX ``ProcessRunner``'s
  final parameters within 1e-5, with equal bytes per node, equal eval
  rounds and accuracies within 1e-6.  The JAX workers run through
  ``tests/_jax_peer.py``, which closes the JAX worker's round-0 inbox race
  (a peer's early rows lost, the peer then taken for dead) and changes
  nothing else.
- Random-k with the int8 wire at budget 0.25: from the JAX parameters,
  the process run equals the port's simulator and the JAX simulator
  within 1e-5.
"""
import dataclasses

import _jax_peer
import jax
import numpy as np

from repro.core import DLConfig as JDLConfig
from repro.core import RoundEngine as JRoundEngine
from repro.runtime import ProcessRunner as JProcessRunner
from repro.runtime import build_workload as jbuild_workload
from repro.utils.pytree import tree_vector as jtree_vector
from repro_torch.convert import mlp_params_from_jax
from repro_torch.core import DLConfig, RoundEngine
from repro_torch.runtime import ProcessRunner, build_workload

WL = {"dataset": "cifar10", "model": "mlp", "width": 1,
      "n_train": 256, "n_test": 128, "lr": 0.05}
ROUNDS = 5
N = 16
# no worker dies in these runs: long death and send timeouts keep a worker
# that a loaded host starves for seconds (its peers' frames unread, its
# beacons late) from being taken for dead, and the join timeout gives four
# workers that import and compile under load time to meet
RUN = dict(workers=4, watchdog_s=120.0, dead_timeout_s=30.0, send_timeout_s=60.0,
           join_timeout_s=180.0)


def _cfg(**kw):
    return dict(n_nodes=N, topology="regular", degree=5, rounds=ROUNDS,
                backend="processes", **kw)


def _port_sim(cfg, init=None):
    dl = DLConfig(**{**cfg, "backend": "simulated"})
    f, loss, acc, opt, batcher = build_workload(WL, dl)
    eng = RoundEngine(dl, f, loss, acc, opt, batcher, init_params=init, device="cpu")
    hist = eng.run(log=False)
    return eng.X.numpy(), hist


def _jax_params(cfg):
    """The JAX engine's initial parameters (numpy leaves)."""
    init, *_ = jbuild_workload(WL, JDLConfig(**cfg))
    keys = jax.random.split(jax.random.key(cfg["seed"]), N)
    return jax.tree_util.tree_map(np.asarray, jax.vmap(init)(keys))


def _check_runner(r, wire):
    assert r.wire_dtype == wire and r.bytes_sent > 0
    assert r.counters["faults_detected"] == 0 and r.counters["retry_total"] == 0
    assert {res["device"] for res in r.worker_results.values()} == {"cpu"}
    # on the CPU the wrappers take their plain twins: no kernel launch
    assert set(r.launches.values()) == {0}
    assert all(res["completed"] for res in r.worker_results.values())


def test_full_sharing_equals_the_port_simulator():
    cfg = _cfg(eval_every=2, seed=3)
    r = ProcessRunner(DLConfig(**cfg), WL, device="cpu", **RUN)
    hist = r.run(log=False)
    X, sim_hist = _port_sim(cfg)
    np.testing.assert_array_equal(r.final_X, X)
    assert [h["round"] for h in hist] == [h["round"] for h in sim_hist] == [0, 2, 4]
    for h, s in zip(hist, sim_hist):
        assert abs(h["acc_mean"] - s["acc_mean"]) < 1e-6
    _check_runner(r, "float32")
    assert len(r.round_wall_s) == ROUNDS and r.n_params == X.shape[1]


def test_full_sharing_equals_the_jax_process_runner(monkeypatch):
    cfg = _cfg(eval_every=2, seed=3)
    params = _jax_params(cfg)
    _jax_peer.jax_runner_launches_this(monkeypatch)
    jr = JProcessRunner(JDLConfig(**cfg), WL, **RUN)
    jhist = jr.run(log=False)
    assert jr.counters["faults_detected"] == 0
    r = ProcessRunner(DLConfig(**cfg), WL, device="cpu", init_params=mlp_params_from_jax(params),
                      **RUN)
    hist = r.run(log=False)
    np.testing.assert_allclose(r.final_X, jr.final_X, rtol=0, atol=1e-5)
    assert [h["round"] for h in hist] == [h["round"] for h in jhist]
    for h, j in zip(hist, jhist):
        assert h["bytes_per_node"] == j["bytes_per_node"]
        assert abs(h["acc_mean"] - j["acc_mean"]) < 1e-6
        assert h["n_live_rows"] == j["n_live_rows"] == N
    assert r.bytes_sent == jr.bytes_sent
    # and the port's simulator from the same parameters
    X, _ = _port_sim(cfg, mlp_params_from_jax(params))
    np.testing.assert_allclose(r.final_X, X, rtol=0, atol=1e-6)
    _check_runner(r, "float32")


def test_randomk_int8_equals_both_simulators():
    cfg = _cfg(eval_every=ROUNDS, seed=4, sharing="randomk", budget=0.25, payload_quant=True)
    params = _jax_params(cfg)
    r = ProcessRunner(DLConfig(**cfg), WL, device="cpu", init_params=mlp_params_from_jax(params),
                      **RUN)
    hist = r.run(log=False)
    X, sim_hist = _port_sim(cfg, mlp_params_from_jax(params))
    np.testing.assert_allclose(r.final_X, X, rtol=0, atol=1e-5)
    jcfg = dataclasses.replace(JDLConfig(**cfg), backend="simulated")
    init, loss, acc, opt, batcher = jbuild_workload(WL, jcfg)
    jeng = JRoundEngine(jcfg, init, loss, acc, opt, batcher)
    jeng.run(log=False)
    jX = np.asarray(jax.vmap(jtree_vector)(jeng.params))
    np.testing.assert_allclose(r.final_X, jX, rtol=0, atol=1e-5)
    assert [h["round"] for h in hist] == [h["round"] for h in sim_hist] == [0, ROUNDS - 1]
    _check_runner(r, "int8")
    assert hist[-1]["wire_dtype"] == "int8"


def test_randomk_fp32_equals_the_port_simulator():
    cfg = _cfg(eval_every=ROUNDS, seed=6, sharing="randomk", budget=0.25)
    r = ProcessRunner(DLConfig(**cfg), WL, device="cpu", **RUN)
    r.run(log=False)
    X, _ = _port_sim(cfg)
    np.testing.assert_array_equal(r.final_X, X)
    _check_runner(r, "float32")
