"""Driver of the emulator's cells: ``repro_torch``'s ``RoundEngine`` with
its synchronous scheduler, over inputs that ``portbench/inputs.py`` makes
from the seed.  One chunk is what ``RoundEngine.run`` does for one span:
``SyncScheduler.run_span`` over ``chunk_rounds`` rounds, then the
evaluation of every node (``RoundEngine._record``), whose host read ends
the chunk."""
from __future__ import annotations

import torch
from torch.profiler import record_function

from portbench import common, counts, inputs
from portbench.reference import dpsgd


class Cell:
    """The engine, built from the seed and driven through its warm steps:
    round 0 and its evaluation, then one whole chunk and its evaluation.
    :attr:`readings` holds what those steps produced, for the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch import DLConfig, RoundEngine
        from repro_torch.data import NodeBatcher
        from repro_torch.optim import make_optimizer
        from repro_torch.quickstart import acc_fn, loss_fn

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        n = cfg["n_nodes"]
        common.log("imports")
        x, y, parts = inputs.images({**cfg["data"], "n_nodes": n}, seed, device)
        init = inputs.init_weights(inputs.gnlenet_plan(cfg["model"]), seed, device)
        common.sync(device)
        common.log("inputs")
        self.x0 = {k: v.clone() for k, v in inputs.leaf_items(init)}
        stacked = {a: {b: v.expand(n, *v.shape) for b, v in leaf.items()}
                   for a, leaf in init.items()}
        knobs = {k: v for k, v in traffic.items() if k in ("sharing", "budget", "secure",
                                                           "participation", "secure_recovery")}
        dl = DLConfig(n_nodes=n, topology=cfg["topology"], degree=cfg["degree"],
                      local_steps=traffic["local_steps"], batch_size=traffic["batch_size"],
                      rounds=1 << 30, chunk_rounds=cfg["chunk_rounds"],
                      eval_every=cfg["chunk_rounds"], network=cfg["network"],
                      seed=inputs.sub_seed(seed, "engine", 31), **knobs)
        batcher = NodeBatcher(x, y, parts, traffic["batch_size"],
                              seed=inputs.sub_seed(seed, "batches", 31))
        self.eng = RoundEngine(dl, _no_draw, loss_fn, acc_fn, make_optimizer("sgd", cfg["lr"]),
                               batcher, init_params=stacked, device=device)
        del stacked, init
        common.sync(device)
        common.log("engine built")
        self.tx, self.ty = x[:cfg["data"]["n_test"]], y[:cfg["data"]["n_test"]].long()
        self.R = cfg["chunk_rounds"]
        self.round = 0
        self.evals = 0
        # the warm steps: round 0, then one whole chunk
        self._span(1)
        first, first_node = self._change_norms(), self._node_change_norms()
        acc = self._acc()
        common.log("round 0")
        self.chunk()
        common.log("warm chunk")
        self.readings = {"first_change": first, "first_node": first_node,
                         "change": self._change_norms(), "node": self._node_change_norms(),
                         "acc": acc + self._acc(), "bytes": [self.eng.bytes_sent],
                         "sim_time": [self.eng.sim_time_s]}
        if traffic.get("secure"):
            h = self.eng.history[-1]
            self.readings["recovery_bytes"] = [h["recovery_bytes"]]
        self.warm_rounds = self.round - 1

    def _span(self, r: int) -> int:
        self.last_span = (self.round, r)
        with record_function("portbench.run_span"):
            self.eng.scheduler.run_span(self.round, r)
        with record_function("portbench.evaluate"):
            self.eng._record(self.round + r - 1, self.tx, self.ty, 0.0, False)
        self.round += r
        self.evals += 1
        return r

    def chunk(self) -> int:
        """One whole chunk: its rounds and the evaluation after them."""
        return self._span(self.R)

    def _acc(self):
        h = self.eng.history[-1]
        return [h["acc_mean"], h["acc_std"]]

    def _change_norms(self):
        out = {}
        for name, leaf in inputs.leaf_items(self.eng.params):
            out[name] = float((leaf - self.x0[name][None]).double().norm())
        return out

    def _node_change_norms(self):
        """Each node's norm of its change from the initial weights, over
        all its leaves."""
        sq = sum((leaf - self.x0[name][None]).double().flatten(1).square().sum(1)
                 for name, leaf in inputs.leaf_items(self.eng.params))
        return sq.sqrt().tolist()

    # -- what the metrics read -------------------------------------------------

    def flops(self, rounds: int, evals: int) -> float:
        """Model FLOPs of the last ``rounds`` rounds and ``evals``
        evaluations run, counting the nodes that took part in each round."""
        d, t, n = self.cfg["data"], self.traffic, self.cfg["n_nodes"]
        masks = self.eng.scheduler.participation_mask(self.round - rounds, rounds)
        return counts.gnlenet_chunk_flops(self.cfg["model"], n, t["local_steps"],
                                          t["batch_size"], rounds, evals, d["n_test"],
                                          float(masks.mean()))

    def share_step(self):
        """A callable: the sharing strategy's step alone on the engine's
        state, for the round after the last one run (its key, its churn
        reweight), as the scheduler stages it."""
        eng, rnd = self.eng, self.round
        act = None
        act_np, _ = eng.scheduler.stage_activity(rnd, 1)
        if act_np is not None:
            act = (torch.as_tensor(act_np[0], device=eng.device), act_np[0])
        W, live = eng.scheduler.stage_topology(rnd, 1)[0]
        Wm, deg, key, kw = eng.steps.share_operands(W, rnd, act, live)
        return lambda: eng.sharing.round(eng.X, Wm, eng.share_state, key=key, degree=deg,
                                         rnd=rnd, **kw)

    def merge_shape(self):
        """(N, K, P, item, rows read): the gather-merge kernel's operands:
        the self slot and the neighbours' over the N rows of the state, or
        under secure aggregation each receiver's D masked messages, N·D
        rows read once."""
        n, d = self.cfg["n_nodes"], self.cfg["degree"]
        if self.traffic.get("secure"):
            return n, d, self.eng.n_params, 4, n * d
        return n, d + 1, self.eng.n_params, 4, n

    def payload_shape(self):
        """(N, P, payload rows, k, slots): the payload merge's operands
        (random-k: every node's k coordinates, the self slot dropped)."""
        if self.traffic["sharing"] != "randomk":
            return None
        n, p = self.cfg["n_nodes"], self.eng.n_params
        return n, p, n, max(1, int(self.traffic["budget"] * p)), self.cfg["degree"]

    def keyed_bounds_ms(self, int_rate: float):
        """Least ms of each keyed secure-mask launch of the last span, in
        launch order: per round the N·D masked messages against their
        D - 1 co-neighbours, then the recovery pass against the
        co-neighbours that sat the round out; one cipher call per pair of
        words and nonzero slot."""
        if not self.traffic.get("secure"):
            return None
        n, p, d = self.cfg["n_nodes"], self.eng.n_params, self.cfg["degree"]
        nbr = self.eng.sharing._nbr
        lanes = (p + 1) // 2
        start, r = self.last_span
        out = []
        for act in self.eng.scheduler.participation_mask(start, r):
            dropped = (1.0 - act[nbr]).sum(1)                  # per receiver
            out.append(counts.keyed_bound_ms(n * d, p, n * d * (d - 1) * lanes, int_rate))
            slots = float((d * dropped - dropped).sum())        # t != s over each receiver's slots
            if self.traffic.get("secure_recovery"):
                out.append(counts.keyed_bound_ms(n * d, p, slots * lanes, int_rate))
        return out

    def finite(self) -> bool:
        return bool(torch.isfinite(self.eng.X).all())

    def free(self):
        del self.eng
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def reference(cfg: dict, traffic: dict, seed: int, device, tf32=False, fault=None):
    """The plain reference's readings of the warm steps, from the seed."""
    return dpsgd.readings(cfg, traffic, seed, device, cfg["chunk_rounds"], tf32=tf32,
                           fault=fault)


def _no_draw(gen):
    raise AssertionError("the benchmark hands the engine its initial weights")
