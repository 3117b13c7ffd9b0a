"""End-to-end training entry point, the port of the JAX package's
``launch/train.py``: decentralized LM training of any ported registry
arch at smoke or full scale, on the card unless ``--device`` says
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --scale smoke --steps 200 --nodes 4 [--device cpu]

The node-stacked D-PSGD trainer (``training/trainer.py``: vmap local
grads, per-node clip, optimizer, gossip), the synthetic token stream in
2-shard non-IID parts, checkpoints in the JAX package's format and a
``history.json`` of the logged steps.  As in the reference the model runs
in fp32, ``regular`` with N <= degree becomes ``fully``, and ``--resume``
restores the parameters only.  Node i's initial parameters come from a
``torch.Generator`` seeded i, so they differ from the reference's
``jax.random`` draws (parity tests inject the JAX parameters).
``--chunk-steps`` steps run per host read of their losses (the
reference's ``lax.scan`` chunk): the losses are the same for any chunk.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, restore_tree, save_checkpoint
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import make_dataset, sharding_partition
from repro_torch.models.api import init_params
from repro_torch.optim import make_optimizer
from repro_torch.training.trainer import (
    TrainConfig,
    init_node_params,
    make_train_step,
    stack_node_params,
)
from repro_torch.utils.pytree import tree_leaves, tree_map


def build_lm_batcher(cfg, n_nodes: int, batch: int, seq: int, seed: int = 0):
    """Token-stream batcher: synthetic Markov LM data, 2-sharded non-IID by
    document class; ``batch_fn(step)`` -> {"tokens", "labels"} (N, B, seq)
    int32 numpy arrays, bitwise the reference's."""
    ds = make_dataset("lm", n_train=n_nodes * 64, n_test=64, seq_len=seq + 1,
                      vocab=min(cfg.vocab, 512), seed=seed)
    parts = sharding_partition(ds.train_y, n_nodes, 2, seed=seed)

    def batch_fn(step: int):
        xs = []
        for i, part in enumerate(parts):
            rng = np.random.default_rng(seed * 999983 + step * 17 + i)
            take = rng.choice(part, batch, replace=len(part) < batch)
            xs.append(ds.train_x[take])
        arr = np.stack(xs)  # (N, B, seq+1)
        return {"tokens": np.ascontiguousarray(arr[:, :, :-1]),
                "labels": np.ascontiguousarray(arr[:, :, 1:])}

    return batch_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--topology", default="regular", choices=["ring", "regular", "fully"])
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="steps per host read of their losses (1 = a read per step)")
    ap.add_argument("--ckpt-dir", default="results/torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


class LMTrainer:
    """The trainer's state: config, node-stacked parameters (views of one
    flat buffer), optimizer state, the step and the batcher.
    ``init_params_tree`` (a node-stacked tree, as
    ``convert.params_from_jax`` returns) and ``opt_state`` replace the
    seeded draws; ``cfg`` replaces the registry's config of ``--arch``
    (one cut in depth, say)."""

    def __init__(self, args, init_params_tree=None, opt_state=None, cfg=None):
        if cfg is None:
            cfg = get_config(args.arch) if args.scale == "full" else get_smoke_config(args.arch)
        if cfg.family == "cnn":
            raise SystemExit("use repro_torch.quickstart for the CNN workload")
        if cfg.family == "encdec":
            # the reference's run fails inside its loss, on the missing "frames"
            raise ValueError(f"{cfg.name} is an encoder-decoder: its loss needs the encoder's "
                             "input frames (batch['frames']), and the token-stream batcher "
                             "gives tokens and labels only")
        self.cfg = cfg.replace(dtype="float32")  # as the reference's launch script forces
        self.device = resolve_device(args.device)
        self.n = args.nodes
        self.topology = args.topology
        if self.topology == "regular" and self.n <= args.degree:
            self.topology = "fully"
        if init_params_tree is None:
            self.params = init_node_params(lambda g: init_params(self.cfg, g), self.n,
                                           self.device)
        else:
            self.params = stack_node_params(_to_device(init_params_tree, self.device))
        self.opt = make_optimizer(args.optimizer, args.lr)
        self.opt_state = (self.opt.init(self.params) if opt_state is None
                          else _to_device(opt_state, self.device))
        self.tc = TrainConfig(n_nodes=self.n, topology=self.topology, degree=args.degree,
                              mixing_impl="roll", grad_clip=1.0)
        self.step_fn = make_train_step(self.cfg, self.opt, self.tc)
        self.batch_fn = build_lm_batcher(self.cfg, self.n, args.batch, args.seq)

    def batches(self, step: int, r: int):
        """Steps ``step .. step + r - 1``'s batches, stacked (r, N, B, S) and
        moved to the device in one copy each."""
        bs = [self.batch_fn(step + s) for s in range(r)]
        return {k: torch.as_tensor(np.stack([b[k] for b in bs])).to(self.device)
                for k in ("tokens", "labels")}

    def run_chunk(self, step: int, r: int) -> torch.Tensor:
        """``r`` steps from ``step``: their mean losses over nodes, (r,) on
        the device (no host read)."""
        batches = self.batches(step, r)
        losses = []
        for s in range(r):
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, {k: v[s] for k, v in batches.items()})
            losses.append(loss)
        return torch.stack(losses)

    def restore(self, ckpt_dir: str) -> int:
        """Parameters (only, as the reference) from the latest checkpoint,
        written into the flat buffer; returns its step."""
        start, trees = load_checkpoint(ckpt_dir)
        saved = restore_tree(self.params, trees["params"])
        for dst, src in zip(tree_leaves(self.params), tree_leaves(saved)):
            dst.copy_(src)
        return start


def _to_device(tree, device):
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def train(args, init_params_tree=None, opt_state=None):
    """The training loop; returns {"losses": every step's mean loss (from
    the first step run), "history": the logged records, "trainer"}."""
    tr = LMTrainer(args, init_params_tree, opt_state)
    print(f"[train] arch={args.arch} scale={args.scale} N={tr.n} topology={tr.topology} "
          f"steps={args.steps} device={tr.device}", flush=True)
    chunk = max(args.chunk_steps, 1)
    start = 0
    if args.resume and latest_checkpoint(args.ckpt_dir) is not None:
        start = tr.restore(args.ckpt_dir)
        print(f"[train] resumed from step {start}", flush=True)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    hist, all_losses = [], []
    t0 = time.time()
    step = start
    while step < args.steps:
        r = min(chunk, args.steps - step)
        losses = tr.run_chunk(step, r).cpu().numpy()
        all_losses.extend(float(l) for l in losses)
        for s in range(r):
            gstep = step + s
            if gstep % args.log_every == 0 or gstep == args.steps - 1:
                l = float(losses[s])
                hist.append({"step": gstep, "loss": l, "wall_s": time.time() - t0})
                print(f"[train] step {gstep:5d} loss {l:.4f} "
                      f"({(time.time() - t0) / max(gstep - start + 1, 1):.2f}s/step)",
                      flush=True)
        step += r
        if (step // args.ckpt_every) > ((step - r) // args.ckpt_every) and step < args.steps:
            save_checkpoint(args.ckpt_dir, step, params=tr.params)
    save_checkpoint(args.ckpt_dir, args.steps, params=tr.params)
    with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
        json.dump(hist, f, indent=1)
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
              f"checkpoint + history in {args.ckpt_dir}", flush=True)
    return {"losses": all_losses, "history": hist, "trainer": tr}


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
