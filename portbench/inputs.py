"""The general input generator: every input of a cell made from the run's
``--seed`` by the benchmark itself and handed alike to the program and to
the reference: images, their labels and their 2-shard non-IID partition;
one node's initial weights (every node starts from them); the token
stream of the language-model cells.  Nothing here imports the program.

Each seed gives the same sizes, only other values, so two seeds do the
same work.  Large tensors are drawn on the device in a few calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one use (``tag``) of the run's seed: any whole number,
    even past 64 bits, maps to a ``bits``-bit one."""
    words = [int(b) for b in tag.encode()]
    state = np.random.SeedSequence([int(seed) % (1 << 64), int(seed) >> 64, *words])
    return int(state.generate_state(1, np.uint64)[0]) >> (64 - bits)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def images(data: dict, seed: int, device):
    """(x, y, parts): ``n_test + n_train`` images (H, W, C) on ``device``,
    each its class prototype plus ``sigma`` times noise, scaled to unit
    variance, the test images first; int64 labels on ``device``; each
    node's train indices into x (``shards_per_node`` label-sorted shards
    each, dealt by a seeded permutation: McMahan et al.'s non-IID split)."""
    shape = tuple(data["image_shape"])
    n_test, n_train, classes = data["n_test"], data["n_train"], data["classes"]
    sigma = float(data["sigma"])
    g = generator(seed, "images", device)
    protos = torch.randn((classes, *shape), generator=g, device=device)
    y = torch.randint(0, classes, (n_test + n_train,), generator=g, device=device)
    x = torch.randn((n_test + n_train, *shape), generator=g, device=device)
    x.mul_(sigma).add_(protos[y]).div_(math.sqrt(1.0 + sigma * sigma))
    parts = shard_partition(y[n_test:].cpu().numpy(), data["n_nodes"], data["shards_per_node"],
                            sub_seed(seed, "partition"))
    return x, y, [p + n_test for p in parts]


def shard_partition(labels: np.ndarray, n_nodes: int, shards: int, seed: int):
    """Each node's sorted sample indices: the samples sorted by label (a
    stable sort), cut into ``n_nodes * shards`` near-equal runs, ``shards``
    runs dealt to each node by a seeded permutation."""
    order = np.argsort(labels, kind="stable")
    runs = np.array_split(order, n_nodes * shards)
    deal = np.random.default_rng(seed).permutation(n_nodes * shards)
    return [np.sort(np.concatenate([runs[s] for s in deal[i * shards:(i + 1) * shards]]))
            for i in range(n_nodes)]


# ---------------------------------------------------------------------------
# initial weights (one node's; every node starts from them)
# ---------------------------------------------------------------------------

def _carve(flat: torch.Tensor, plan):
    """Views of ``flat`` in the order of ``plan`` ((path, shape, kind,
    scale) rows): 'normal' rows scaled in place, 'ones'/'zeros' filled."""
    tree, off = {}, 0
    for path, shape, kind, scale in plan:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if kind == "normal":
            leaf.mul_(scale)
        else:
            leaf.fill_(1.0 if kind == "ones" else 0.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def gnlenet_plan(m: dict):
    """GN-LeNet's leaves: HWIO 5x5 convolutions of ``width`` and
    ``2 * width`` channels, each with a bias and a GroupNorm scale and
    shift, then fc (2·width·(H/4)·(W/4) -> fc_hidden) and the classifier."""
    c0, c1, c2 = m["channels"], m["width"], 2 * m["width"]
    k = m["kernel"]
    flat_in = c2 * (m["image"] // 4) ** 2
    plan = []
    for name, cin, cout in (("conv1", c0, c1), ("conv2", c1, c2)):
        plan += [((name, "w"), (k, k, cin, cout), "normal", (k * k * cin) ** -0.5),
                 ((name, "b"), (cout,), "zeros", 0.0), ((name, "g"), (cout,), "ones", 0.0),
                 ((name, "be"), (cout,), "zeros", 0.0)]
    plan += [(("fc1", "w"), (flat_in, m["fc_hidden"]), "normal", flat_in ** -0.5),
             (("fc1", "b"), (m["fc_hidden"],), "zeros", 0.0),
             (("fc2", "w"), (m["fc_hidden"], m["classes"]), "normal", m["fc_hidden"] ** -0.5),
             (("fc2", "b"), (m["classes"],), "zeros", 0.0)]
    return plan


def lm_plan(m: dict):
    """A Llama-style decoder's leaves, the layers stacked on a leading
    axis: the tied embedding, the final norm, and per layer two RMSNorm
    weights, the q/k/v/o projections and the SwiGLU MLP, (in, out)."""
    d, L, ff, v = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"], m["vocab_size"]
    hd = d // m["num_attention_heads"]
    q, kv = m["num_attention_heads"] * hd, m["num_key_value_heads"] * hd
    std = m["initializer_range"]
    lay = ("dense_layers",)
    return [
        (("embed",), (v, d), "normal", std),
        (("final_norm",), (d,), "ones", 0.0),
        (lay + ("ln1",), (L, d), "ones", 0.0),
        (lay + ("ln2",), (L, d), "ones", 0.0),
        (lay + ("attn", "w_q"), (L, d, q), "normal", d ** -0.5),
        (lay + ("attn", "w_k"), (L, d, kv), "normal", d ** -0.5),
        (lay + ("attn", "w_v"), (L, d, kv), "normal", d ** -0.5),
        (lay + ("attn", "w_o"), (L, q, d), "normal", q ** -0.5),
        (lay + ("mlp", "w_gate"), (L, d, ff), "normal", d ** -0.5),
        (lay + ("mlp", "w_up"), (L, d, ff), "normal", d ** -0.5),
        (lay + ("mlp", "w_down"), (L, ff, d), "normal", ff ** -0.5),
    ]


def init_weights(plan, seed: int, device):
    """One node's weights for ``plan``: a single normal draw on the
    device, cut into leaves."""
    total = sum(math.prod(shape) for _, shape, _, _ in plan)
    flat = torch.randn((total,), generator=generator(seed, "weights", device), device=device)
    return _carve(flat, plan)


def leaf_items(tree, prefix=""):
    """(dotted name, tensor) of every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaf_items(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

class TokenStream:
    """A seeded class-conditional Markov token stream, non-IID over nodes:
    ``classes`` successor tables over the first ``draw_vocab`` ids, each id
    with ``branching`` successors; node i draws its rows from classes
    ``(c_i, c_i + 1) mod classes``.  :meth:`batch` is a pure function of
    (seed, step): the program and the reference read the same rows."""

    def __init__(self, traffic: dict, n_nodes: int, seed: int):
        self.n, self.b, self.s = n_nodes, traffic["batch"], traffic["seq"]
        self.v, self.branch = traffic["draw_vocab"], traffic["branching"]
        rng = np.random.default_rng(sub_seed(seed, "token-tables"))
        self.succ = rng.integers(0, self.v, (traffic["classes"], self.v, self.branch))
        first = rng.permutation(traffic["classes"])[np.arange(n_nodes) % traffic["classes"]]
        self.node_classes = np.stack([first, (first + 1) % traffic["classes"]], 1)
        self.seed = sub_seed(seed, "tokens")

    def batch(self, step: int):
        """{"tokens", "labels"}: (N, B, S) int32 numpy arrays, the labels
        the tokens shifted by one."""
        rng = np.random.default_rng([self.seed, int(step)])
        pick = rng.integers(0, 2, (self.n, self.b))
        cls = self.node_classes[np.arange(self.n)[:, None], pick]
        out = np.empty((self.n, self.b, self.s + 1), np.int64)
        out[:, :, 0] = rng.integers(0, self.v, (self.n, self.b))
        choice = rng.integers(0, self.branch, (self.n, self.b, self.s))
        for t in range(1, self.s + 1):
            out[:, :, t] = self.succ[cls, out[:, :, t - 1], choice[:, :, t - 1]]
        out = out.astype(np.int32)
        return {"tokens": np.ascontiguousarray(out[:, :, :-1]),
                "labels": np.ascontiguousarray(out[:, :, 1:])}
