"""Driver of the language-model trainer's cells: ``repro_torch``'s
``LMTrainer`` (node-stacked D-PSGD: vmap(grad) per node, the per-node
clip, SGD, one gossip launch over the flat (N, P) buffer per step) over
weights and a token stream that ``portbench/inputs.py`` makes from the
seed.  One chunk is ``LMTrainer.run_chunk`` over ``chunk_steps`` steps
and the host read of their losses."""
from __future__ import annotations

import argparse

import torch
from torch.profiler import record_function

from portbench import common, counts, inputs
from portbench.reference import lm


def model_config(m: dict):
    """The program's ``ModelConfig`` of the published sizes in ``m``."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name=m["name"], family="dense", n_layers=m["num_hidden_layers"],
                       d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
                       n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
                       vocab=m["vocab_size"], tie_embeddings=m["tie_word_embeddings"],
                       rope_theta=m["rope_theta"], norm_eps=m["rms_norm_eps"],
                       dtype=m["train_dtype"])


class Cell:
    """The trainer, built from the seed and driven through its warm steps:
    step 0 alone, then one whole chunk."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.launch.train import LMTrainer

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        m, n = cfg["model"], cfg["n_nodes"]
        common.log("imports")
        init = inputs.init_weights(inputs.lm_plan(m), seed, device)
        self.x0 = dict(inputs.leaf_items(init))
        stacked = _expand(init, n)
        args = argparse.Namespace(arch=m["name"], scale="full", nodes=n, batch=traffic["batch"],
                                  seq=traffic["seq"], lr=cfg["lr"], topology=cfg["topology"],
                                  degree=cfg["degree"], optimizer="sgd", device=device)
        self.tr = LMTrainer(args, init_params_tree=stacked, cfg=model_config(m))
        del stacked, init
        self.tr.batch_fn = inputs.TokenStream(traffic, n, seed).batch
        common.sync(device)
        common.log("trainer built")
        self.R = cfg["chunk_steps"]
        self.step = 0
        losses = self._run(1)
        first = self._change_norms()
        common.log("step 0")
        losses += self._run(self.R)
        common.log("warm chunk")
        self.readings = {"loss": losses, "first_change": first,
                         "change": self._change_norms()}
        self.warm_rounds = self.step - 1

    def _run(self, r: int):
        with record_function("portbench.run_chunk"):
            losses = self.tr.run_chunk(self.step, r)
        with record_function("portbench.read_losses"):
            out = [float(v) for v in losses.cpu().numpy()]
        self.step += r
        return out

    def chunk(self) -> int:
        """One whole chunk: its steps and the host read of their losses."""
        self._run(self.R)
        return self.R

    def _change_norms(self):
        return {name: float((leaf - self.x0[name][None]).double().norm())
                for name, leaf in inputs.leaf_items(self.tr.params)}

    # -- what the metrics read -------------------------------------------------

    def flops(self, steps: int, evals: int) -> float:
        return steps * counts.lm_step_flops(self.cfg["model"], self.cfg["n_nodes"],
                                            self.traffic["batch"], self.traffic["seq"])

    def merge_shape(self):
        n = self.cfg["n_nodes"]
        return n, self.cfg["degree"] + 1, counts.lm_params(self.cfg["model"]), 4, n

    def finite(self) -> bool:
        return all(bool(torch.isfinite(leaf).all()) for _, leaf in inputs.leaf_items(self.tr.params))

    def free(self):
        del self.tr
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def reference(cfg: dict, traffic: dict, seed: int, device, tf32=False, fault=None):
    """The plain reference's readings of the warm steps, from the seed."""
    return lm.readings(cfg, traffic, seed, device, cfg["chunk_steps"], tf32=tf32,
                       fault=fault)


def _expand(tree, n):
    if isinstance(tree, dict):
        return {k: _expand(v, n) for k, v in tree.items()}
    return tree.expand(n, *tree.shape)
