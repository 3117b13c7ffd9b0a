"""The async cohort gather/scatter path of the port against the JAX
package's, and its parts.

Bitwise against JAX: ``node_batch_indices`` for any subset of ids,
``sample_neighbor_slots``, ``gather_rows`` and the bf16/int8 cold-row
codes (``encode_cold`` under ``jit``).  Whole cohort runs of both engines
on the regression model of ``tests/test_cohort.py`` (p_dim=8, 12 nodes,
``batch_keying="node"``) from the same initial parameters: flat and
hierarchical selection, fp32/bf16/int8 cold rows, pairwise gossip under
churn and the LAN model — parameters within 1e-5, bytes, events,
occupancy, overflow and fallbacks equal, times within rtol 1e-6.  Within
the port: cohort at C = N equals the dense async path bitwise over the
six scenario axes of ``tests/test_cohort.py``, hier equals flat bitwise,
overflow carry is fair, the clock rebase leaves trajectories unchanged,
and ``memory_model()`` equals the reference's dict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_engine_parity import BATCH, _data, _jtiny_loss, tiny_acc, tiny_loss
from repro.core import DLConfig as JDLConfig
from repro.core import RoundEngine as JRoundEngine
from repro.core import compression as jcomp
from repro.core.topology import SparseTopology as JSparseTopology
from repro.core.topology import gather_rows as jgather_rows
from repro.core.topology import sample_neighbor_slots as jsample_neighbor_slots
from repro.data import NodeBatcher as JNodeBatcher
from repro.data.loader import node_batch_indices as jnode_batch_indices
from repro.optim import make_optimizer as jmake_optimizer
from repro.utils.pytree import tree_vector as jtree_vector
from repro_torch import DLConfig, RoundEngine, prng
from repro_torch.core import compression as tcomp
from repro_torch.core.topology import SparseTopology, gather_rows, sample_neighbor_slots
from repro_torch.data import NodeBatcher
from repro_torch.data.loader import node_batch_indices
from repro_torch.optim import make_optimizer

P_DIM = 8
BASE = dict(n_nodes=12, topology="regular", degree=4, local_steps=1, batch_size=BATCH,
            rounds=12, eval_every=6, chunk_rounds=4, semantics="async", compute_time_s=1e-3,
            batch_keying="node", seed=3)
# the scenario axes of tests/test_cohort.py
SCENARIOS = {
    "base": dict(),
    "stragglers": dict(straggler_frac=0.5, straggler_factor=3.0),
    "churn": dict(participation=0.7),
    "churn_lan": dict(participation=0.7, network="lan"),
    "pairwise_churn": dict(async_gossip="pairwise", participation=0.8),
    "dynamic": dict(topology="dynamic"),
}


def _jax_engine(cfg):
    ds, parts = _data(cfg["n_nodes"], "tiny")
    return JRoundEngine(JDLConfig(**cfg), lambda k: {"w": jax.random.normal(k, (P_DIM,))},
                        _jtiny_loss, lambda p, x, y: -_jtiny_loss(p, x, y),
                        jmake_optimizer("sgd", 0.05),
                        JNodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0))


def _torch_engine(cfg, init=None):
    ds, parts = _data(cfg["n_nodes"], "tiny")
    return RoundEngine(DLConfig(**cfg), lambda g: {"w": torch.randn((P_DIM,), generator=g)},
                       tiny_loss, tiny_acc, make_optimizer("sgd", 0.05),
                       NodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0),
                       init_params=init, device="cpu")


def _jax_init(cfg):
    """The JAX engine's initial (pre-encoding) parameters."""
    keys = jax.random.split(jax.random.key(cfg["seed"]), cfg["n_nodes"])
    return {"w": np.asarray(jax.vmap(lambda k: jax.random.normal(k, (P_DIM,)))(keys))}


def _jw(eng):
    dec = jcomp.decode_cold(eng.params, eng.dl.cold_dtype)
    return np.asarray(jax.vmap(jtree_vector)(dec))


def _tw(eng):
    return eng.scheduler.eval_params()["w"].numpy()


# ---------------------------------------------------------------------------
# the parts, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ids", [list(range(12)), [1, 3, 4, 9, 11], [7], [11, 0, 5]])
def test_node_batch_indices_bitwise_jax(ids):
    ds, parts = _data(12, "tiny")
    jb = JNodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0)
    tb = NodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0)
    jlens, jpad = jb.device_tables()
    tlens, tpad = tb.device_tables("cpu")
    jkey = jax.random.fold_in(jax.random.key(20), 0x0BA7)
    tkey = prng.fold_in(prng.key(20), 0x0BA7)
    for rnd in (0, 5, 1 << 20):
        want = np.asarray(jnode_batch_indices(jkey, rnd, jnp.asarray(ids), jlens, jpad, 2, 4))
        got = node_batch_indices(tkey, rnd, torch.tensor(ids), tlens, tpad, 2, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        full = node_batch_indices(tkey, rnd, torch.arange(12), tlens, tpad, 2, 4)
        np.testing.assert_array_equal(full[:, ids].numpy(), want)


def _padded_table(n=16, d=5, seed=0):
    """A topology whose rows have 0..d valid slots (padding has w = 0)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, size=(n, d)).astype(np.int32)
    deg = rng.integers(0, d + 1, size=n)
    valid = np.arange(d)[None, :] < deg[:, None]
    nbr = np.where(valid, nbr, np.arange(n)[:, None]).astype(np.int32)
    w = np.where(valid, rng.uniform(0.05, 0.2, size=(n, d)), 0.0).astype(np.float32)
    return nbr, w, (1.0 - w.sum(1)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_neighbor_slots_and_gather_rows_bitwise_jax(seed):
    nbr, w, ws = _padded_table(seed=seed)
    jt = JSparseTopology(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(ws))
    tt = SparseTopology(torch.as_tensor(nbr), torch.as_tensor(w), torch.as_tensor(ws))
    for k in (0, 7, 123):
        want = np.asarray(jsample_neighbor_slots(jax.random.key(k), jt))
        got = sample_neighbor_slots(prng.key(k), tt)
        np.testing.assert_array_equal(got.numpy(), want)
        rows = np.array([3, 0, 15, 8], np.int32)
        jc = jgather_rows(jt, jnp.asarray(rows))
        tc = gather_rows(tt, torch.as_tensor(rows).long())
        for a, b in zip((tc.nbr, tc.w, tc.w_self), (jc.nbr, jc.w, jc.w_self)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        want = np.asarray(jsample_neighbor_slots(jax.random.key(k), jc, rows=jnp.asarray(rows)))
        got = sample_neighbor_slots(prng.key(k), tc, rows=torch.as_tensor(rows))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cold_codes_bitwise_jax(mode):
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(6, 3, 4)).astype(np.float32) * 3,
            "b": rng.normal(size=(6, 7)).astype(np.float32),
            "t": np.arange(6, dtype=np.int32)}
    tree["b"][2] = 0.0  # an all-zero row: the scale floor
    want = jax.jit(lambda t: jcomp.encode_cold(t, mode))(tree)
    got = tcomp.encode_cold({k: torch.as_tensor(v) for k, v in tree.items()}, mode)
    for k in ("a", "b"):
        if mode == "int8":
            np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want[k].q))
            np.testing.assert_array_equal(got[k].s.numpy(), np.asarray(want[k].s))
        else:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
    assert got["t"].dtype == torch.int32
    dec = tcomp.decode_cold(got, mode)
    jdec = jax.jit(lambda t: jcomp.decode_cold(t, mode))(want)
    for k in tree:
        np.testing.assert_array_equal(dec[k].numpy(), np.asarray(jdec[k]))
    assert tcomp.cold_tree_bytes(got) == jcomp.cold_tree_bytes(want)
    if mode == "int8":  # re-encoding decoded rows reproduces the codes
        again = tcomp.encode_cold(dec, mode)
        np.testing.assert_array_equal(again["a"].q.numpy(), got["a"].q.numpy())


# ---------------------------------------------------------------------------
# whole cohort runs against the JAX engine
# ---------------------------------------------------------------------------

SPREAD = dict(compute_spread=3.0, async_slice_s=0.01)
RUNS = {
    "flat fp32": dict(cohort_capacity=5, straggler_frac=0.25, straggler_factor=4.0),
    "hier fp32": dict(cohort_capacity=4, selection="hier", segment_size=2, **SPREAD),
    "hier int8": dict(cohort_capacity=4, selection="hier", segment_size=2, cold_dtype="int8",
                      **SPREAD),
    "flat bf16": dict(cohort_capacity=6, cold_dtype="bf16", straggler_frac=0.25,
                      straggler_factor=4.0),
    "pairwise churn lan": dict(cohort_capacity=5, async_gossip="pairwise", participation=0.8,
                               network="lan", straggler_frac=0.25, straggler_factor=4.0),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cohort_engine_matches_jax(name):
    cfg = dict(BASE, **RUNS[name])
    jeng = _jax_engine(cfg)
    init = _jax_init(cfg)
    teng = _torch_engine(cfg, {"w": torch.tensor(init["w"])})
    jeng.run(log=False)
    teng.run(log=False)
    np.testing.assert_allclose(_tw(teng), _jw(jeng), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(teng.scheduler._events.numpy(),
                                  np.asarray(jeng.scheduler._events))
    assert teng.bytes_sent == jeng.bytes_sent > 0
    assert teng.sim_time_s == pytest.approx(jeng.sim_time_s, rel=1e-6)
    for h, jh in zip(teng.history, jeng.history):
        assert h.keys() == jh.keys()
        for k in jh:
            if k == "sim_time_s" or k.startswith("vclock"):
                assert h[k] == pytest.approx(jh[k], rel=1e-6), k
            elif k not in ("wall_s", "acc_mean", "acc_std"):
                assert h[k] == jh[k], k
    if "hier" in name:
        assert teng.history[-1]["selection_fallback_total"] < cfg["rounds"]


# ---------------------------------------------------------------------------
# the reference's oracles within the port
# ---------------------------------------------------------------------------

def _run(**kw):
    e = _torch_engine(dict(BASE, **kw))
    e.run(log=False)
    return e


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_full_capacity_cohort_equals_dense_bitwise(scenario):
    kw = SCENARIOS[scenario]
    dense, coh = _run(**kw), _run(cohort_capacity=12, **kw)
    np.testing.assert_array_equal(_tw(dense), _tw(coh))
    assert torch.equal(dense.scheduler._events, coh.scheduler._events)
    assert coh.bytes_sent == dense.bytes_sent
    assert coh.sim_time_s == dense.sim_time_s
    md, mc = dense.history[-1], coh.history[-1]
    for k in ("events_total", "staleness_mean", "staleness_max", "vclock_max_s",
              "vclock_median_s"):
        assert mc[k] == md[k], k


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_hier_selection_equals_flat_bitwise(scenario):
    kw = dict(SCENARIOS[scenario], n_nodes=24)
    flat = _run(cohort_capacity=6, selection="flat", **kw)
    hier = _run(cohort_capacity=6, selection="hier", segment_size=4, **kw)
    np.testing.assert_array_equal(_tw(flat), _tw(hier))
    assert torch.equal(flat.scheduler._events, hier.scheduler._events)
    assert hier.bytes_sent == flat.bytes_sent and hier.sim_time_s == flat.sim_time_s
    mf, mh = flat.history[-1], hier.history[-1]
    for k in ("cohort_occupancy_mean", "cohort_overflow_total", "staleness_mean"):
        assert mh[k] == mf[k], k
    assert (mf["cohort_selection"], mh["cohort_selection"]) == ("flat", "hier")


@pytest.mark.parametrize("n,spread", [(23, 0.0), (48, 0.0), (96, 15.0)])
def test_hier_equals_flat_with_fallbacks_odd_populations_and_pruning(n, spread):
    """A wide slice takes the flat fallback (counted), an odd population
    pads its last segment past N, and a continuous spread lets the
    segments prune — each bitwise the flat selection."""
    kw = dict(n_nodes=n, rounds=10, eval_every=9)
    if spread:
        kw.update(compute_spread=spread,
                  async_slice_s=float(0.8 * 8 * (1e-3 * spread) / (n * np.log1p(spread))))
    elif n == 48:
        kw.update(async_slice_s=1e9, straggler_frac=0.5, straggler_factor=3.0)
    c = 8 if spread else (4 if n == 48 else 5)
    flat = _run(cohort_capacity=c, selection="flat", **kw)
    hier = _run(cohort_capacity=c, selection="hier", segment_size=4, **kw)
    np.testing.assert_array_equal(_tw(flat), _tw(hier))
    assert torch.equal(flat.scheduler._events, hier.scheduler._events)
    fb = hier.history[-1]["selection_fallback_total"]
    if n == 48:
        assert fb > 0
    if spread:
        assert fb < 10 and hier.scheduler._n_seg > hier.scheduler._seg_k


def test_overflow_carry_is_fair():
    """12 homogeneous nodes at C=4: each step 12 tie and the 4 lowest ids
    fire; over 12 steps every node fires exactly 4 events."""
    e = _run(seed=1, cohort_capacity=4)
    np.testing.assert_array_equal(e.scheduler._events.numpy(), np.full(12, 4))
    m = e.scheduler.extra_metrics()
    assert m["cohort_occupancy_mean"] == 4.0 and m["cohort_overflow_total"] > 0
    assert m["events_total"] == 48


def test_rebase_leaves_the_cohort_equal_to_dense():
    kw = dict(compute_time_s=30_000.0, straggler_frac=0.25, straggler_factor=2.0, seed=5)
    dense, coh = _run(**kw), _run(cohort_capacity=12, **kw)
    hier = _run(n_nodes=12, cohort_capacity=6, selection="hier", segment_size=4, **kw)
    flat = _run(n_nodes=12, cohort_capacity=6, selection="flat", **kw)
    np.testing.assert_array_equal(_tw(dense), _tw(coh))
    assert coh.sim_time_s == dense.sim_time_s > 65536.0
    assert coh.scheduler._t_offset > 0
    np.testing.assert_array_equal(_tw(flat), _tw(hier))
    # the carried segment minima stay exact after the shift
    t = hier.scheduler._t_next
    want = [float(t[i:i + 4].min()) for i in range(0, 12, 4)]
    np.testing.assert_array_equal(hier.scheduler._seg_min.numpy(), np.float32(want))


@pytest.mark.parametrize("kw", [dict(cohort_capacity=5),
                                dict(cohort_capacity=4, selection="hier", segment_size=3,
                                     cold_dtype="int8"),
                                dict(cohort_capacity=6, cold_dtype="bf16", topology="dynamic")],
                         ids=["flat-fp32", "hier-int8", "bf16-dynamic"])
def test_memory_model_equals_jax(kw):
    cfg = dict(BASE, **kw)
    want = _jax_engine(cfg).scheduler.memory_model()
    assert _torch_engine(cfg).scheduler.memory_model() == want


def test_checkpoints_of_compressed_cold_rows_raise(tmp_path):
    """save_state refuses every async engine with the reference's
    ValueError (its clocks are not checkpointed); load_state keeps the
    port's NotImplementedError for cold rows, where the reference has no
    semantics check."""
    eng = _torch_engine(dict(BASE, cohort_capacity=4, cold_dtype="int8"))
    assert eng.X is None and eng.params["w"].shape == (12, P_DIM)
    with pytest.raises(ValueError, match="synchronous barrier state only"):
        eng.save_state(str(tmp_path))
    with pytest.raises(NotImplementedError, match="cold rows"):
        eng.load_state(str(tmp_path))


SAVE_SEMANTICS = {"local": dict(semantics="local", batch_keying="stream"),
                  "async-fp32": dict(),
                  "async-cohort-fp32": dict(cohort_capacity=4),
                  "sync": dict(semantics="sync", batch_keying="stream")}


@pytest.mark.parametrize("name", list(SAVE_SEMANTICS))
def test_save_state_refuses_clocked_semantics_as_jax(name, tmp_path):
    """save_state raises the reference's ValueError, with its message,
    under semantics 'local' and 'async' (fp32 state, so the cold-row check
    would pass), and still saves under 'sync'."""
    cfg = dict(BASE, **SAVE_SEMANTICS[name])
    eng, jeng = _torch_engine(cfg), _jax_engine(cfg)
    if cfg["semantics"] == "sync":
        path = eng.save_state(str(tmp_path / "t"))
        assert path.endswith("ckpt_00000000.npz")
        assert jeng.save_state(str(tmp_path / "j")).endswith("ckpt_00000000.npz")
        return
    with pytest.raises(ValueError) as want:
        jeng.save_state(str(tmp_path / "j"))
    with pytest.raises(ValueError) as got:
        eng.save_state(str(tmp_path / "t"))
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "t").exists()
