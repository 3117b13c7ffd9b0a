"""Checkpointing: a tree of tensors -> one flat ``.npz`` and a structure
JSON, in the JAX package's file format, so a checkpoint written by either
package loads in the other.

``ckpt_%08d.npz`` holds one array per leaf under ``<tree>::<path>``, the
path the dict keys and sequence indices joined by ``/``; ``ckpt_%08d.json``
holds the step and each tree's leaf shapes and dtypes.  Node-stacked
leaves keep the node axis first, so each node's slice is self-contained.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch


def _walk(tree, path=()):
    """(path, leaf) pairs of nested dicts, tuples and lists, dict keys in
    sorted order (the JAX package's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _walk(t, path + (str(i),))
    else:
        yield path, tree


def _flatten(tree):
    return {"/".join(path): np.asarray(torch.as_tensor(leaf).detach().cpu())
            for path, leaf in _walk(tree)}


def save_checkpoint(path: str, step: int, **trees) -> str:
    """save_checkpoint(dir, 100, params=..., opt_state=...) -> file path.

    Crash-consistent: the meta JSON is written first and the ``.npz``
    lands through a temp file and ``os.replace``, so a process killed
    mid-save leaves at most a stray meta file, never a truncated archive
    that :func:`latest_checkpoint` (which matches ``.npz`` names only)
    would pick up."""
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    payload = {}
    meta = {"step": step, "trees": {}}
    for tname, tree in trees.items():
        flat = _flatten(tree)
        meta["trees"][tname] = {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()}
        payload.update({f"{tname}::{k}": v for k, v in flat.items()})
    with open(os.path.join(path, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    tmp = fn + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, fn)
    return fn


def load_checkpoint(path: str, step: Optional[int] = None):
    """(step, {tree name: nested dict of numpy leaves}), the latest step
    in ``path`` unless ``step`` names one."""
    if step is None:
        step = latest_checkpoint(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
    data = np.load(os.path.join(path, f"ckpt_{step:08d}.npz"))
    out: dict = {}
    for key in data.files:
        tname, leaf_path = key.split("::", 1)
        node = out.setdefault(tname, {})
        parts = leaf_path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return step, out


def restore_tree(like: Any, nested: Optional[dict]):
    """A tree with ``like``'s structure from the nested-dict form
    :func:`load_checkpoint` returns: each leaf a tensor in its saved dtype
    on the device of ``like``'s leaf.  ``nested=None`` (a tree with no
    leaves, such as stateless sharing's ``()``) returns ``like``."""
    if nested is None:
        return like

    def pick(t, node):
        if isinstance(t, dict):
            return {k: pick(t[k], node[str(k)]) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(pick(v, node[str(i)]) for i, v in enumerate(t))
        return torch.as_tensor(np.asarray(node), device=torch.as_tensor(t).device)

    return pick(like, nested)


def latest_checkpoint(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(path)
        if (m := re.match(r"ckpt_(\d+)\.npz$", f))
    ]
    return max(steps) if steps else None
