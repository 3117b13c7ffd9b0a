"""Batched serving demo on the port: initialise a smoke-scale model from
the architecture registry and serve a batch of requests through the
KV-cache decode path (the twin of the JAX package's ``examples/serve.py``).

    PYTHONPATH=src python -m repro_torch.serve [--arch smollm-135m] [--batch 4] [--device cpu]

Weights come from a ``torch.Generator`` seeded 0 and prompts from numpy's
``default_rng(1)``, so the ids differ from the JAX demo's (``jax.random``).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.api import init_params
from repro_torch.serving import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=[a for a in ARCHS if a != "gn-lenet"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.family in ("encdec",):
        print("serve.py demos decoder-only archs; whisper decode is covered "
              "by tests/test_decode_consistency.py")
        return
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(cfg, ServeConfig(batch=args.batch, max_len=128), params, dev)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (args.batch, 8))
    out = engine.generate(torch.as_tensor(prompts, device=dev), max_new=args.max_new).cpu()
    print(f"arch={args.arch} (smoke config, family={cfg.family})")
    for b in range(args.batch):
        print(f"  request {b}: prompt={list(map(int, prompts[b]))} -> "
              f"generated={list(map(int, out[b]))}")


if __name__ == "__main__":
    main()
