"""Port parity of the node-sharded mixings on S=4 gloo ranks of the CPU.

* ``mix_sparse_shmap``: backends 'gather' and 'ppermute' (exchanging by
  the slot-rebalanced table's schedule, merging in the table's own slot
  order) bitwise the port's single-device ``mix_sparse``; both within
  rtol 2e-5 / atol 2e-6 of the JAX
  package's ``mix_sparse`` (the reference's own tolerance for its sharded
  mix); the bytes each rank sends equal the schedule's prediction:
  (S-1)·B·P·4 for the all-gather, the crossing rows times P·4 for the
  slot exchange.
* the payload merges over a ``ShardedTopology`` (uniform and strided
  payloads, exact and quantized values): bitwise the single-device merge
  on the same table.
* ``mix_circulant_shmap`` and ``mix_compressed_circulant_shmap`` (one
  node per rank) against the JAX functions on a 4-device mesh of
  ``--xla_force_host_platform_device_count=8``, run once in a subprocess
  as ``tests/test_sharded_engine.py`` runs its mesh tests.
* ``ShardedTopology.neighbor_stack`` and ``_permute_block`` against the
  global table's rows.
* ``NodeShard``'s collectives: gather, psum, pmax, the rank's rows, and no
  staging of CPU tensors; a failed or hung rank fails the whole call.

One spawn of the 4 ranks (a module fixture) computes every sharded case.
"""
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_ranks as ranks
from repro.core import mixing as jmix
from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro_torch.core import mixing as tmix
from repro_torch.core.topology import Graph, SparseTopology, decompose_slot_permutations
from repro_torch.launch import shard

S = 4
GRAPHS = {"rr8d4": (8, 4, 1), "rr32d5": (32, 5, 1), "circ16d5": (16, 5, None)}
CIRC = {  # name: (degree, mode, budget)
    "roll_d2": (2, "roll", None), "roll_d3": (3, "roll", None),
    "sparse_d2": (2, "sparse", 0.3), "sparse_d3": (3, "sparse", 0.3),
    "sparse_full_d2": (2, "sparse", 1.0), "quant_d2": (2, "quant", None),
    "sparse+quant_d3": (3, "sparse+quant", 0.3),
}


def _graph(G, n, d, seed):
    return G.regular_circulant(n, d) if seed is None else G.random_regular(n, d, seed=seed)


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 9)).astype(np.float32)}


def _circ_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 33, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 257)).astype(np.float32)}


def _payload(n, p, k, seed, strided):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    if strided:
        stride = p // k
        phase = rng.integers(0, stride, size=n).astype(np.int32)
        idx = np.arange(k, dtype=np.int32)[None, :] * stride + phase[:, None]
        return X, phase, np.take_along_axis(X, idx, 1)
    idx = np.sort(np.stack([rng.choice(p, k, replace=False) for _ in range(n)]), 1).astype(np.int32)
    val = np.take_along_axis(X, idx, 1) + rng.normal(size=(n, k)).astype(np.float32) * 0.01
    return X, idx, val


def _topo_arrays(st):
    return tuple(np.asarray(a) for a in (st.nbr, st.w, st.w_self))


def _cases():
    sparse, payload = {}, {}
    for g, (n, d, seed) in GRAPHS.items():
        st = SparseTopology.from_graph(_graph(Graph, n, d, seed))
        for backend in ("gather", "ppermute"):
            sparse[f"{g}/{backend}"] = dict(topo=_topo_arrays(st), tree=_tree(n, n + d),
                                            backend=backend)
    st = SparseTopology.from_graph(_graph(Graph, 16, 5, None))
    for backend in ("gather", "ppermute"):
        for strided in (False, True):
            for exact in (True, False):
                payload[f"{backend}/strided={strided}/exact={exact}"] = dict(
                    topo=_topo_arrays(st), backend=backend, strided=strided, exact=exact,
                    operands=_payload(16, 40, 8, 7, strided))
    circulant = {name: dict(n=S, degree=d, mode=mode, budget=budget, tree=_circ_tree(S, i))
                 for i, (name, (d, mode, budget)) in enumerate(CIRC.items())}
    st = SparseTopology.from_graph(_graph(Graph, 32, 5, 1))
    Y = np.random.default_rng(5).normal(size=(32, 3, 2)).astype(np.float32)
    stack = {b: dict(topo=_topo_arrays(st), backend=b, Y=Y) for b in ("gather", "ppermute")}
    return {"sparse": sparse, "payload": payload, "circulant": circulant, "stack": stack}


JAX_CIRCULANT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.mixing import mix_circulant_shmap, mix_compressed_circulant_shmap
    data = np.load(sys.argv[1], allow_pickle=True)["cases"].item()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    out = {}
    for name, c in data.items():
        t = {k: jax.numpy.asarray(v) for k, v in c["tree"].items()}
        specs = {k: P("data", *((None,) * (v.ndim - 1))) for k, v in t.items()}
        if c["mode"] == "roll":
            fn = lambda t: mix_circulant_shmap(t, mesh, ("data",), c["degree"])
        else:
            fn = lambda t: mix_compressed_circulant_shmap(
                t, specs, mesh, ("data",), c["degree"], budget=c["budget"] or 0.1,
                mode=c["mode"])
        out[name] = {k: np.asarray(v) for k, v in jax.jit(fn)(t).items()}
    np.savez(sys.argv[2], out=np.asarray(out, dtype=object))
""")


@pytest.fixture(scope="module")
def sharded():
    return shard.run(ranks.mixing_cases, S, _cases(), device="cpu", timeout=300)


@pytest.fixture(scope="module")
def jax_circulant(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_circ")
    cases = _cases()["circulant"]
    np.savez(d / "in.npz", cases=np.asarray(cases, dtype=object))
    r = subprocess.run([sys.executable, "-c", JAX_CIRCULANT, str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return np.load(d / "out.npz", allow_pickle=True)["out"].item()


@pytest.mark.parametrize("g", list(GRAPHS))
@pytest.mark.parametrize("backend", ["gather", "ppermute"])
def test_mix_sparse_shmap(sharded, g, backend):
    n, d, seed = GRAPHS[g]
    st = SparseTopology.from_graph(_graph(Graph, n, d, seed))
    tree = _tree(n, n + d)
    got, sent = sharded[f"sparse/{g}/{backend}"]
    # the port's single-device merge on the same table
    want = tmix.mix_sparse({k: torch.as_tensor(v) for k, v in tree.items()}, st.to("cpu"))
    for k in tree:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    jst = JSparse.from_graph(_graph(JGraph, n, d, seed))
    jwant = jmix.mix_sparse({k: jnp.asarray(v) for k, v in tree.items()},
                            jax.tree_util.tree_map(jnp.asarray, jst), use_pallas=False)
    for k in tree:
        np.testing.assert_allclose(got[k], np.asarray(jwant[k]), rtol=2e-5, atol=2e-6)
    # rank 0's bytes on the wire, as the schedule predicts them
    b = n // S
    row = sum(v[0].size for v in tree.values()) * 4
    if backend == "gather":
        assert sent == (S - 1) * b * row
    else:
        dec = decompose_slot_permutations(st)
        crossing = sum(int((dec.nbr[:b, s] // b != 0).sum()) for s in range(d))
        sched = tmix.PermuteSchedule.from_table(dec.nbr, S).plan(0, b)
        assert len(sched.send_rows) * row == sent
        assert sched.n_recv == crossing  # the rows rank 0 reads from other ranks


@pytest.mark.parametrize("name", sorted(_cases()["payload"]))
def test_sharded_payload_merge_is_the_single_device_merge(sharded, name):
    case = _cases()["payload"][name]
    st = SparseTopology(*case["topo"])
    X, idx, val = (torch.as_tensor(a) for a in case["operands"])
    fn = tmix.mix_payload_strided if case["strided"] else tmix.mix_payload
    want = fn(st.to("cpu"), idx, val, X, exact_values=case["exact"])
    np.testing.assert_array_equal(sharded[f"payload/{name}"], want.numpy())


@pytest.mark.parametrize("name", list(CIRC))
def test_circulant_shmaps_match_jax(sharded, jax_circulant, name):
    got, sent = sharded[f"circulant/{name}"]
    want = jax_circulant[name]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6)
    degree, mode, budget = CIRC[name]
    links = 2 if degree == 2 else 3  # offsets 1 (two directions) and the antipodal 2
    tree = _cases()["circulant"][name]["tree"]
    sizes = [v[0].size for v in tree.values()]
    if mode == "roll":
        assert sent == links * sum(sizes) * 4
    elif mode == "quant":  # int8 codes and one fp32 scale per row
        assert sent == links * sum(p + 4 for p in sizes)
    elif mode == "sparse":  # int32 index and fp32 value per kept coordinate
        assert sent == links * sum(max(1, int(budget * p)) * 8 for p in sizes)


def test_sparse_budget_one_equals_the_uncompressed_mix(sharded):
    """A full budget shares every coordinate: the compressed wire's merge
    equals the plain circulant shmap's to fp32 rounding."""
    full, _ = sharded["circulant/sparse_full_d2"]
    tree = _cases()["circulant"]["sparse_full_d2"]["tree"]
    want = tmix.mix_circulant({k: torch.as_tensor(v) for k, v in tree.items()}, S, 2)
    for k in tree:
        np.testing.assert_allclose(full[k], want[k].numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("backend", ["gather", "ppermute"])
def test_neighbor_stack_and_permute_block(sharded, backend):
    """``ShardedTopology.neighbor_stack`` gives each receiver its
    neighbours' rows in its table's slot order (with either backend), and
    ``_permute_block`` applies one slot's permutation of the rebalanced
    table."""
    case = _cases()["stack"][backend]
    st = SparseTopology(*case["topo"])
    stack, blocks = sharded[f"stack/{backend}"]
    np.testing.assert_array_equal(stack, case["Y"][np.asarray(st.nbr)])
    dec = decompose_slot_permutations(st)
    assert len(blocks) == (0 if backend == "gather" else dec.nbr.shape[1])
    for s, block in enumerate(blocks):
        np.testing.assert_array_equal(block, case["Y"][dec.nbr[:, s]])


def test_node_shard_collectives(sharded):
    gathered, summed, maxed, rows, staged = sharded["collectives"]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(gathered, np.concatenate([x + 10 * r for r in range(S)]))
    np.testing.assert_array_equal(summed, S * x + 10 * sum(range(S)))
    np.testing.assert_array_equal(maxed, x + 10 * (S - 1))
    np.testing.assert_array_equal(rows, [0, 1])
    assert staged == 0  # CPU tensors on gloo move as they are


def test_sharded_operands_need_a_group():
    with pytest.raises(RuntimeError, match="launch.shard.run"):
        tmix.NodeShard.of_group(8)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tmix.mix_circulant_shmap({"a": torch.zeros(1, 3)}, None, 2)


def test_rank_failure_fails_the_run():
    """A rank that raises fails the whole call with its traceback; the
    other ranks are stopped, not waited for."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        shard.run(ranks.fail_on_rank_one, 2, device="cpu", timeout=60)


def test_hung_rank_fails_the_run_at_its_timeout():
    """Rank 1 sleeps past the call's timeout, which also bounds the
    ranks' start: 20 s leaves two spawned interpreters time to import
    torch and join the group on a loaded machine."""
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] still running"):
        shard.run(ranks.hang_on_rank_one, 2, device="cpu", timeout=20)


@pytest.mark.parametrize("device", [{"device": "cuda"}, {}], ids=["cuda", "default"])
def test_no_card_raises(device):
    """Asked for the card, or for no device (the card by default), with no
    card: the launcher raises before it starts a rank."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.run(ranks.fail_on_rank_one, 2, timeout=30, **device)
