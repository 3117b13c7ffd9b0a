"""The port's real-network backend (``repro_torch.runtime``) against the
JAX package's, with no worker process spawned.

- ROWS frames and the control-plane bodies equal the reference's
  ``transport`` encoders byte for byte, for every format; decode round
  trips; truncated frames, trailing garbage and over-limit frames are
  refused;
- ``Membership`` driven through the same random event sequences as the
  reference's gives the same answers and snapshots;
- ``ProcessRunner``'s launcher validation (``tests/test_runtime.py``'s
  cases), ``DLConfig.validate``'s processes rules (accepted and refused
  as the reference's, with its messages), ``RoundEngine``'s refusal and
  ``DecentralizedRunner``'s dispatch;
- ``localhost_deployment``'s round time, the calibration fit and its
  file, ``build_workload``'s data, and ``_randk_idx(rows=...)``: a block
  of global ids draws the reference's index sets;
- the rendezvous registry hands every worker the full peer map.
"""
import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import DLConfig as JDLConfig
from repro.core import build_graph as jbuild_graph
from repro.core import network as jnetwork
from repro.core import sharing as jsharing
from repro.core.faults import FaultPlan as JFaultPlan
from repro.runtime import build_workload as jbuild_workload
from repro.runtime import calibrate as jcalibrate
from repro.runtime import membership as jmembership
from repro.runtime import transport as JT
from repro_torch import prng
from repro_torch.core import DecentralizedRunner, DLConfig, FaultPlan, RoundEngine
from repro_torch.core import network as tnetwork
from repro_torch.core import sharing as tsharing
from repro_torch.runtime import ProcessRunner, build_workload
from repro_torch.runtime import calibrate as tcalibrate
from repro_torch.runtime import membership as tmembership
from repro_torch.runtime import transport as T

WL = {"dataset": "cifar10", "model": "mlp", "width": 1,
      "n_train": 256, "n_test": 128, "lr": 0.05}


# ---------------------------------------------------------------------------
# wire codec: the port's frames are the reference's bytes
# ---------------------------------------------------------------------------

def _payloads(fmt, n, width, seed):
    rng = np.random.default_rng(seed)
    if fmt == T.FMT_FULL_F32:
        return {"rows": rng.standard_normal((n, width)).astype(np.float32)}
    idx = rng.integers(0, 10 * width, (n, width)).astype(np.int32)
    if fmt == T.FMT_PAYLOAD_F32:
        return {"idx": idx, "val": rng.standard_normal((n, width)).astype(np.float32)}
    return {"idx": idx, "codes": rng.integers(-127, 128, (n, width)).astype(np.int8),
            "scale": rng.random(n).astype(np.float32)}


FORMATS = {"full_f32": T.FMT_FULL_F32, "payload_f32": T.FMT_PAYLOAD_F32,
           "payload_i8": T.FMT_PAYLOAD_I8}


def test_frame_constants_equal_the_reference():
    names = ("MSG_ROWS", "MSG_HEARTBEAT", "MSG_BYE", "MSG_JOIN", "MSG_WELCOME",
             "MSG_STATE_REQ", "MSG_STATE", "FMT_FULL_F32", "FMT_PAYLOAD_F32",
             "FMT_PAYLOAD_I8", "MAX_FRAME_BYTES")
    assert [getattr(T, k) for k in names] == [getattr(JT, k) for k in names]
    for s in ("_FRAME", "_ROWS_HDR", "_WID", "_PEER"):
        assert getattr(T, s).format == getattr(JT, s).format


@pytest.mark.parametrize("fmt", list(FORMATS))
@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**20))
def test_rows_frames_are_the_reference_bytes(fmt, seed):
    rng = np.random.default_rng(seed)
    n, width = int(rng.integers(0, 9)), int(rng.integers(1, 17))
    ids = rng.choice(1000, n, replace=False).astype(np.int32)
    rnd, sender, epoch = int(rng.integers(0, 2**32)), int(rng.integers(0, 2**16)), \
        int(rng.integers(0, 2**16))
    pay = _payloads(FORMATS[fmt], n, width, seed)
    body = T.encode_rows(rnd, sender, ids, FORMATS[fmt], epoch=epoch, **pay)
    assert body == JT.encode_rows(rnd, sender, ids, FORMATS[fmt], epoch=epoch, **pay)
    out = T.decode_rows(body)
    assert (out["round"], out["sender"], out["epoch"], out["fmt"]) == \
        (rnd, sender, epoch, FORMATS[fmt])
    np.testing.assert_array_equal(out["ids"], ids)
    for k, v in pay.items():
        np.testing.assert_array_equal(out[k], v)
        assert out[k].dtype == v.dtype
    ref = JT.decode_rows(body)
    assert sorted(ref) == sorted(out)


def test_control_bodies_are_the_reference_bytes():
    assert T.encode_wid(13) == JT.encode_wid(13) and T.decode_wid(T.encode_wid(13)) == 13
    assert T.encode_peer(13, 2) == JT.encode_peer(13, 2)
    assert T.decode_peer(T.encode_peer(13, 2)) == (13, 2)
    msg = {"phase": "commit", "worker": 3, "epoch": 1, "start_round": 17}
    assert T.encode_json(msg) == JT.encode_json(msg) and T.decode_json(T.encode_json(msg)) == msg


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_truncated_and_trailing_frames_are_refused(fmt):
    ids = np.array([0, 5], np.int32)
    body = T.encode_rows(0, 0, ids, FORMATS[fmt], **_payloads(FORMATS[fmt], 2, 4, 0))
    with pytest.raises(ValueError):
        T.decode_rows(body[:-2])
    with pytest.raises(ValueError, match="length mismatch"):
        T.decode_rows(body + b"xx")
    with pytest.raises(ValueError, match="unknown ROWS fmt"):
        T.encode_rows(0, 0, ids, 9, rows=np.zeros((2, 4), np.float32))


def test_frame_limits_are_asserted(monkeypatch):
    """n_rows is a uint16 and a body stays under MAX_FRAME_BYTES: a frame
    past either raises instead of being split or truncated."""
    ids = np.arange(0x10000, dtype=np.int32)
    with pytest.raises(ValueError, match="65535"):
        T.encode_rows(0, 0, ids, T.FMT_FULL_F32, rows=np.zeros((0x10000, 1), np.float32))
    body = T.encode_rows(0, 0, ids[:0xFFFF], T.FMT_FULL_F32,
                         rows=np.zeros((0xFFFF, 1), np.float32))
    assert T.decode_rows(body)["ids"].shape == (0xFFFF,)
    monkeypatch.setattr(T, "MAX_FRAME_BYTES", 64)
    with pytest.raises(ValueError, match="MAX_FRAME_BYTES"):
        T.encode_rows(0, 0, ids[:2], T.FMT_FULL_F32, rows=np.zeros((2, 8), np.float32))


def test_read_frame_refuses_an_oversized_length_prefix():
    async def go():
        r = asyncio.StreamReader()
        r.feed_data(T._FRAME.pack(T.MSG_ROWS, T.MAX_FRAME_BYTES + 1))
        return await T.read_frame(r)

    with pytest.raises(ValueError, match="sanity bound"):
        asyncio.run(go())


# ---------------------------------------------------------------------------
# membership: the same events, the same answers
# ---------------------------------------------------------------------------

def test_counter_schema_is_the_reference():
    assert tmembership.RUNTIME_COUNTER_KEYS == jmembership.RUNTIME_COUNTER_KEYS
    assert tmembership.zero_counters() == jmembership.zero_counters()


def _event(rng, n):
    v = int(rng.integers(0, n + 1))  # n: a worker id outside the mesh
    ep = int(rng.integers(0, 4))
    kind = rng.choice(["frame", "heartbeat", "silent", "dead", "left", "hello",
                       "admit_at", "due", "admit", "beacons"])
    return kind, v, ep, float(rng.integers(0, 40)), int(rng.integers(0, 20)), \
        int(rng.integers(0, 20))


def _apply(m, ev):
    kind, v, ep, now, start, cur = ev
    known = v < m.n
    if kind == "frame":
        return m.frame_status(v, ep)
    if kind == "beacons":
        return (m.peers(), m.live_peers(), m.beacon_targets())
    if kind == "due":
        return m.due_admissions(cur)
    if not known:
        return None
    return {"heartbeat": lambda: m.heartbeat(v, ep, now),
            "silent": lambda: m.silent_too_long(v, now),
            "dead": lambda: m.declare_dead(v), "left": lambda: m.declare_left(v),
            "hello": lambda: m.hello(v, ep),
            "admit_at": lambda: m.schedule_admit(v, ep, start, cur),
            "admit": lambda: m.admit(v)}[kind]()


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_membership_walks_the_reference_event_sequences(seed):
    rng = np.random.default_rng(seed)
    n, wid = int(rng.integers(2, 6)), 0
    wid = int(rng.integers(0, n))
    t, j = tmembership.Membership(n, wid, 3.0), jmembership.Membership(n, wid, 3.0)
    for _ in range(int(rng.integers(1, 60))):
        ev = _event(rng, n)
        assert _apply(t, ev) == _apply(j, ev), ev
        assert t.snapshot() == j.snapshot()
        assert t.last_seen == j.last_seen


# ---------------------------------------------------------------------------
# launcher validation (no processes spawned)
# ---------------------------------------------------------------------------

def _pdl(**kw):
    return DLConfig(n_nodes=8, backend="processes", **kw)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dl=DLConfig(n_nodes=8), workers=2), "backend='processes'"),
    (dict(dl=DLConfig(n_nodes=10, backend="processes"), workers=4), "divide evenly"),
    (dict(workers=0), "workers must be"),
    (dict(workers=2, kill_worker=1), "pair"),
    (dict(workers=2, kill_worker=5, kill_at_round=1), "out of range"),
    (dict(workers=2, chaos_plan=[{"worker": 7, "kill_at_round": 1}]), "out of range"),
    (dict(workers=2, chaos_plan=[{"worker": 1, "kill_at_round": -1}]), "kill_at_round"),
], ids=["simulated", "uneven", "no-workers", "pair", "kill-range", "plan-range", "plan-round"])
def test_runner_validation(kwargs, match):
    dl = kwargs.pop("dl", _pdl())
    with pytest.raises(ValueError, match=match):
        ProcessRunner(dl, WL, device="cpu", **kwargs)


def test_runner_chaos_plan_normalized():
    r = ProcessRunner(_pdl(), WL, workers=2, kill_worker=1, kill_at_round=2, device="cpu")
    assert r.chaos_plan == [{"worker": 1, "kill_at_round": 2, "rejoin": False}]
    r = ProcessRunner(_pdl(), WL, workers=2, device="cpu", chaos_plan=[
        {"worker": 1, "kill_at_round": 9}, {"worker": 0, "kill_at_round": 2, "rejoin": False}])
    assert [e["kill_at_round"] for e in r.chaos_plan] == [2, 9]
    assert r.chaos_plan[1]["rejoin"] is True
    assert r.device == "cpu" and r.wire_dtype == "float32"
    assert ProcessRunner(_pdl(sharing="randomk", payload_quant=True), WL, workers=2,
                         device="cpu").wire_dtype == "int8"


def test_runner_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcessRunner(_pdl(), WL, workers=2)


# ---------------------------------------------------------------------------
# DLConfig.validate: the processes rules, as the reference's
# ---------------------------------------------------------------------------

PROCESSES_ACCEPTED = {
    "full": dict(), "randomk": dict(sharing="randomk"), "random": dict(sharing="random"),
    "randomk-int8": dict(sharing="randomk", payload_quant=True),
    "ring": dict(topology="ring"), "random-regular": dict(topology="random-regular"),
    "network": dict(network="lan"), "payload-on": dict(sharing="randomk", payload="on"),
}
PROCESSES_REJECTED = {
    "shard": (dict(shard_devices=2), None), "local": (dict(semantics="local"), None),
    "async": (dict(semantics="async"), None), "secure": (dict(secure=True), None),
    "faults": (dict(), dict(msg_loss=0.1)), "churn": (dict(participation=0.9), None),
    "machines": (dict(churn_machines=2), None), "cohort": (dict(cohort_capacity=4), None),
    "node-keying": (dict(batch_keying="node"), None), "fully": (dict(topology="fully"), None),
    "star": (dict(topology="star"), None), "dense": (dict(mixing="dense"), None),
    "dynamic": (dict(topology="dynamic"), None), "topk": (dict(sharing="topk"), None),
    "choco": (dict(sharing="choco"), None), "quant": (dict(sharing="quant"), None),
    "strided": (dict(sharing="randomk", randk_sampler="strided"), None),
    "unknown-backend": (dict(backend="mpi"), None),
    "secure-dynamic": (dict(secure=True, topology="dynamic"), None),
}


@pytest.mark.parametrize("name", list(PROCESSES_ACCEPTED))
def test_processes_configs_accepted_as_jax(name):
    kw = dict(n_nodes=16, backend="processes", **PROCESSES_ACCEPTED[name])
    JDLConfig(**kw).validate()
    DLConfig(**kw).validate()


@pytest.mark.parametrize("name", list(PROCESSES_REJECTED))
def test_processes_configs_rejected_as_jax(name):
    knobs, plan = PROCESSES_REJECTED[name]
    kw = dict(n_nodes=16, **{"backend": "processes", **knobs})
    with pytest.raises(ValueError) as want:
        JDLConfig(**kw, faults=None if plan is None else JFaultPlan(**plan)).validate()
    with pytest.raises(ValueError) as got:
        DLConfig(**kw, faults=None if plan is None else FaultPlan(**plan)).validate()
    assert str(got.value) == str(want.value)


def test_round_engine_refuses_the_process_backend():
    init, loss, acc, opt, batcher = build_workload(WL, DLConfig(n_nodes=8))
    with pytest.raises(ValueError, match="RoundEngine is the simulated backend"):
        RoundEngine(_pdl(), init, loss, acc, opt, batcher, device="cpu")


def test_runner_dispatches_to_the_process_backend():
    r = DecentralizedRunner(_pdl(), workload=WL, device="cpu", workers=2, ckpt_every=3)
    assert isinstance(r.engine, ProcessRunner)
    assert r.engine.workers == 2 and r.engine._cfg["ckpt_every"] == 3
    assert r.history == [] and r.bytes_sent == 0.0 and r.engine.device == "cpu"
    with pytest.raises(ValueError, match="workload="):
        DecentralizedRunner(_pdl(), device="cpu")
    init, loss, acc, opt, batcher = build_workload(WL, DLConfig(n_nodes=8))
    with pytest.raises(TypeError, match="simulated backend"):
        DecentralizedRunner(DLConfig(n_nodes=8), init, loss, acc, opt, batcher, device="cpu",
                            workers=2)


# ---------------------------------------------------------------------------
# the network model, the calibration fit, the workload, the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,degree,nbytes", [(16, 5, 4 * 3_000), (32, 4, 1e6), (8, 3, 17.0)])
def test_localhost_round_time_equals_jax(n, degree, nbytes):
    cfg = dict(n_nodes=n, topology="regular", degree=degree)
    want = jnetwork.localhost_deployment(n).round_time(jbuild_graph(JDLConfig(**cfg)), nbytes,
                                                       compute_time_s=0.0)
    from repro_torch.core.engine import build_graph

    got = tnetwork.localhost_deployment(n).round_time(build_graph(DLConfig(**cfg)), nbytes,
                                                      compute_time_s=0.0)
    assert got == want


def test_calibrated_localhost_reads_the_ports_file(tmp_path):
    path = str(tmp_path / "cal.json")
    assert tnetwork.load_calibration_fit(path) is None
    assert tnetwork.calibrated_localhost(8, path).overhead_s == 0.0
    with open(path, "w") as f:
        json.dump({"fit": {"alpha_s": 0.0125, "beta_s_per_byte": 1e-9}}, f)
    assert tnetwork.calibrated_localhost(8, path).overhead_s == \
        jnetwork.calibrated_localhost(8, path).overhead_s == 0.0125
    assert tnetwork.CALIBRATION_PATH == tcalibrate.DEFAULT_OUT != jcalibrate.DEFAULT_OUT


def test_calibration_fit_equals_jax():
    pts = [{"implied_compute_s": a, "bytes_per_round": b}
           for a, b in ((0.011, 1e5), (0.013, 4e5), (0.0122, 2e5), (0.02, 9e5))]
    assert tcalibrate.fit_overhead(pts) == jcalibrate.fit_overhead(pts)
    assert tcalibrate.fit_overhead(pts[:1]) == jcalibrate.fit_overhead(pts[:1])


@pytest.mark.parametrize("wl", [WL, dict(WL, model="cnn", width=2, optimizer="momentum")])
def test_build_workload_data_equals_jax(wl):
    dl = DLConfig(n_nodes=8, seed=5, batch_size=4)
    tinit, _, _, _, tb = build_workload(wl, dl)
    jinit, _, _, _, jb = jbuild_workload(wl, JDLConfig(n_nodes=8, seed=5, batch_size=4))
    np.testing.assert_array_equal(tb.x, jb.x)
    np.testing.assert_array_equal(tb.y, jb.y)
    np.testing.assert_array_equal(tb.round_indices(3, 2), jb.round_indices(3, 2))
    t = tinit(torch.Generator().manual_seed(0))
    j = jinit(jax.random.key(0))
    shapes = lambda tree: {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))  # noqa
                           for k, v in tree.items()}
    assert shapes(t) == shapes(j)


@pytest.mark.parametrize("lo,hi,p,k", [(4, 8, 40, 10), (0, 3, 17, 5), (12, 16, 64, 1)])
def test_randk_rows_draw_the_reference_sets(lo, hi, p, k):
    key = 1234
    rows = np.arange(lo, hi)
    want = np.asarray(jsharing._randk_idx(jax.random.fold_in(jax.random.key(key + 17), 3),
                                          (hi - lo, p), k, rows=jax.numpy.asarray(rows)))
    got = tsharing._randk_idx(prng.fold_in(prng.key(key + 17), 3), (hi - lo, p), k, "cpu",
                              rows=torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, np.sort(want, 1))
    # the block's rows are the full draw's rows lo..hi
    full = tsharing._randk_idx(prng.fold_in(prng.key(key + 17), 3), (hi, p), k, "cpu").numpy()
    np.testing.assert_array_equal(got, full[lo:hi])


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------

def test_rendezvous_hands_every_worker_the_peer_map():
    srv = T.RendezvousServer(3)
    host, port = srv.start()
    try:
        async def go():
            return await asyncio.gather(*[
                T.rendezvous_register(host, port, w, "127.0.0.1", 40000 + w, timeout_s=10.0)
                for w in range(3)])

        maps = asyncio.run(go())
        want = {w: ("127.0.0.1", 40000 + w) for w in range(3)}
        assert all(m == want for m in maps)
        # a late (re)connection gets the map at once, from the reference client too
        late = asyncio.run(JT.rendezvous_register(host, port, 1, "127.0.0.1", 41001,
                                                  timeout_s=10.0))
        assert late[1] == ("127.0.0.1", 41001) and late[0] == want[0]
    finally:
        srv.stop()
    assert isinstance(T.free_port(), int)
