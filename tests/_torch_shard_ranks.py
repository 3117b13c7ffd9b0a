"""Rank functions of the node-sharding tests (``test_torch_shard_*.py``),
run on every rank of a gloo group by ``repro_torch.launch.shard.run``.

They import torch and the port only, so that a spawned rank does not
import JAX, and take and return numpy.  Each returns rank 0's view of the
results: where a result is per rank, the ranks' blocks are all-gathered
first.
"""
import torch


def _gather_tree(shard, tree):
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda a: shard.gather(a).numpy(), tree)


def _local(tree, shard):
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda a: torch.as_tensor(shard.local(a)).clone(), tree)


def mixing_cases(cases, device):
    """mix_sparse_shmap, the sharded payload merges, the circulant shmaps
    and the NodeShard collectives on this rank; see
    ``test_torch_shard_mixing.py``."""
    from repro_torch.core.mixing import (
        NodeShard,
        _permute_block,
        mix_circulant_shmap,
        mix_compressed_circulant_shmap,
        mix_payload,
        mix_payload_strided,
        mix_sparse_shmap,
        shard_topology,
    )
    from repro_torch.core.topology import SparseTopology

    out = {}
    for name, case in cases["sparse"].items():
        st = SparseTopology(*case["topo"])
        shard = NodeShard.of_group(st.n)
        local = _local(case["tree"], shard)
        before = shard.sent_bytes
        mixed = mix_sparse_shmap(local, st, shard, backend=case["backend"])
        sent = shard.sent_bytes - before
        out[f"sparse/{name}"] = (_gather_tree(shard, mixed), sent)
    for name, case in cases["payload"].items():
        st = SparseTopology(*case["topo"])
        shard = NodeShard.of_group(st.n)
        W = shard_topology(st, shard, device, case["backend"])
        X, idx, val = (torch.as_tensor(shard.local(a)) for a in case["operands"])
        if case["strided"]:
            got = mix_payload_strided(W, idx, val, X, exact_values=case["exact"])
        else:
            got = mix_payload(W, idx, val, X, exact_values=case["exact"])
        out[f"payload/{name}"] = shard.gather(got).numpy()
    for name, case in cases["circulant"].items():
        shard = NodeShard.of_group(case["n"])
        local = _local(case["tree"], shard)
        before = shard.sent_bytes
        if case["mode"] == "roll":
            mixed = mix_circulant_shmap(local, shard, case["degree"])
        else:
            mixed = mix_compressed_circulant_shmap(local, shard, case["degree"],
                                                   budget=case["budget"], mode=case["mode"])
        sent = shard.sent_bytes - before
        out[f"circulant/{name}"] = (_gather_tree(shard, mixed), sent)
    for name, case in cases["stack"].items():
        st = SparseTopology(*case["topo"])
        shard = NodeShard.of_group(st.n)
        W = shard_topology(st, shard, device, case["backend"])
        Y = torch.as_tensor(shard.local(case["Y"]))
        blocks = [_permute_block(Y, slot, shard) for slot in W.sched.slots] if W.sched else []
        out[f"stack/{name}"] = (shard.gather(W.neighbor_stack(Y)).numpy(),
                                [shard.gather(b).numpy() for b in blocks])
    shard = NodeShard.of_group(8)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * shard.rank
    out["collectives"] = (shard.gather(x).numpy(), shard.psum(x).numpy(),
                          shard.pmax(x).numpy(), shard.rows().numpy(), shard.staged_bytes)
    return out


def consensus_loss(p, x, y):
    t = x.reshape(x.shape[0], -1).mean(0)
    return torch.mean((p["w"].reshape(-1, t.shape[0]) - t) ** 2)


def consensus_acc(p, x, y):
    return -consensus_loss(p, x, y)


def consensus_engine(device="cpu", init_params=None, **kw):
    """The reference's sharded-engine test configuration
    (``tests/test_sharded_engine.py``): the consensus model over 16
    parameters, 16 nodes, batch 4, chunks of 4, evaluations every 4."""
    from repro_torch import DLConfig, RoundEngine
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.optim import make_optimizer

    ds = make_dataset("cifar10", n_train=256, n_test=32, shape=(2, 2, 1), sigma=2.0)
    n = kw.setdefault("n_nodes", 16)
    parts = sharding_partition(ds.train_y, n, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, batch_size=4, seed=0)
    kw.setdefault("chunk_rounds", 4)
    dl = DLConfig(eval_every=4, local_steps=1, batch_size=4, **kw)
    return RoundEngine(dl, lambda g: {"w": torch.randn((16,), generator=g, device=g.device)}, consensus_loss,
                       consensus_acc, make_optimizer("sgd", 0.05), batcher,
                       init_params=init_params, device=device)


def engine_summary(eng):
    return {"X": eng.full_state().cpu().numpy(), "history": eng.history,
            "bytes_sent": eng.bytes_sent, "sim_time_s": eng.sim_time_s,
            "share_stage_bytes": eng.share_stage_bytes,
            "topo_stage_bytes_peak": eng.topo_stage_bytes_peak, "wire_dtype": eng.wire_dtype}


def engine_cases(cases, rounds=8, ckpt_dir=None, *, device):
    """Each case's sharded run (or the exception its construction raises)
    on this rank; with ``ckpt_dir``, a run saved after 4 rounds and
    resumed by a fresh engine."""
    import torch.distributed as dist

    ranks = dist.get_world_size()
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        init = kw.pop("init_params", None)
        try:
            eng = consensus_engine(device, init_params=init, shard_devices=ranks, **kw)
        except ValueError as e:
            out[name] = ("ValueError", str(e))
            continue
        eng.run(rounds=rounds, log=False)
        out[name] = engine_summary(eng)
        out[name]["backend"] = eng._shard_backend
    if ckpt_dir is not None:
        kw = dict(topology="regular", degree=5, sharing="topk", payload="on",
                  shard_backend="ppermute")
        eng = consensus_engine(device, shard_devices=ranks, **kw)
        eng.run(rounds=4, log=False)
        path = eng.save_state(ckpt_dir)
        again = consensus_engine(device, shard_devices=ranks, **kw)
        step = again.load_state(ckpt_dir)
        again.run(rounds=rounds, log=False)
        out["resumed"] = dict(engine_summary(again), path=path, step=step)
    return out


def trainer_cases(case, device):
    """The sharded LM train step (one node per rank) for each mixing of
    ``case["modes"]``, ``case["steps"]`` steps from the given node-stacked
    parameters and batches; returns per mode (losses, gathered params)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.mixing import NodeShard
    from repro_torch.optim import make_optimizer
    from repro_torch.training import trainer
    from repro_torch.utils.pytree import tree_map

    cfg = get_smoke_config(case["arch"])
    shard = NodeShard.of_group(case["n"])
    out = {}
    for mode in case["modes"]:
        tc = trainer.TrainConfig(n_nodes=case["n"], topology=case["topology"],
                                 degree=case["degree"], mixing_impl=mode, budget=case["budget"],
                                 grad_clip=1.0)
        opt = make_optimizer("sgd", case["lr"])
        params = _local(params_from_jax(case["params"]), shard)
        state = opt.init(params)
        step = trainer.make_train_step(cfg, opt, tc, shard=shard)
        losses = []
        for b in case["batches"]:
            params, state, loss = step(params, state, _local(params_from_jax(b), shard))
            losses.append(float(loss))
        out[mode] = (losses, _gather_tree(shard, params))
    return out


def fail_on_rank_one(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return "ok"


def hang_on_rank_one(device):
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(120)
    return "ok"
