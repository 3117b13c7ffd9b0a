"""Plain reference of the emulator's synchronous D-PSGD rounds on
GN-LeNet: every node's local SGD steps on its own batches, then one
gossip step over a static circulant overlay with Metropolis-Hastings
weights (full sharing, or random-k sharing of each node's top-k
coordinates by seeded uniforms), each node's accuracy on the shared test
images, and the bytes and simulated time a round costs on the paper's
16-machine LAN.  It works out again everything the emulator derives from
the inputs: the batch indices, the overlay and its weights, the random-k
draws, the accounting.  Float32, node blocks at a time."""
from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference import gnlenet, threefry
from portbench.reference.precision import Products

# the paper's testbed: nodes dealt round-robin over 16 machines, loopback
# links within a machine, 1 Gbit/s LAN links with 200 us latency between
MACHINES = 16
LOOPBACK = (20e-6, 20e9)
LAN = (200e-6, 1e9)
TRAIN_BLOCK, EVAL_BLOCK, SHARE_BLOCK = 256, 16, 64


def circulant(n: int, degree: int):
    """(nbr (N, D) int64, w (N, D) float32, w_self (N,) float32): node i's
    neighbours at offsets +-1 .. +-degree//2 (and n/2 for an odd degree),
    Metropolis-Hastings weights 1 / (1 + max(deg_i, deg_j))."""
    offs = list(range(1, degree // 2 + 1)) + ([n // 2] if degree % 2 else [])
    i = np.arange(n)[:, None]
    cols = []
    for o in offs:
        cols.append((i + o) % n)
        if (2 * o) % n:
            cols.append((i - o) % n)
    nbr = np.sort(np.concatenate(cols, 1), 1)
    w = np.full(nbr.shape, 1.0 / (1.0 + degree))
    return nbr, w.astype(np.float32), (1.0 - w.sum(1)).astype(np.float32)


def batch_indices(parts, seed: int, rnd: int, steps: int, batch: int) -> np.ndarray:
    """(steps, N, B) sample indices of round ``rnd``: one PCG64 stream a
    round, uniforms truncated onto each node's part (with replacement)."""
    lens = np.array([len(p) for p in parts])
    u = np.random.default_rng((seed * 1_000_003 + rnd) * 1_000_003 + 99_991).random(
        (steps, len(parts), batch))
    loc = (u * lens[None, :, None]).astype(np.int64)
    return np.stack([np.stack([parts[i][loc[s, i]] for i in range(len(parts))])
                     for s in range(steps)])


def lan_round_s(nbr: np.ndarray, nbytes: float, degree, live=None) -> float:
    """The synchronous round's simulated seconds: the slowest node's
    serialized sends on its live edges (every edge where ``live`` is
    None), latency plus a message's bytes over goodput per edge, in the
    float32 arithmetic the emulator states for its clock: the bytes of a
    message are the round's bytes times the float32 reciprocal of a static
    degree (over a churn round's float32 degree), each edge's time
    latency + bytes * 8 / goodput, a node's edges summed in slot order."""
    f32 = np.float32
    same = (np.arange(nbr.shape[0])[:, None] % MACHINES) == (nbr % MACHINES)
    lat = np.where(same, f32(LOOPBACK[0]), f32(LAN[0])).astype(f32)
    gp = np.where(same, f32(LOOPBACK[1]), f32(LAN[1])).astype(f32)
    if isinstance(degree, np.floating):
        per_edge = f32(nbytes) / f32(degree)
    else:
        per_edge = f32(nbytes) * f32(1.0 / degree)
    t = (f32(1.0) if live is None else live.astype(f32)) * (lat + per_edge * f32(8.0) / gp)
    node = t[:, 0]
    for k in range(1, t.shape[1]):
        node = node + t[:, k]
    return float(node.max())


def participation(seed: int, rnd: int, n: int, p: float) -> np.ndarray:
    """(N,) float32 {0,1}: which nodes take part in round ``rnd``.  A
    splitmix64 hash of (seed, round, node) mapped to a uniform in [0, 1),
    up below ``p``; where every node drew down, the hash of a further
    unit picks one to keep up."""
    if p >= 1.0:
        return np.ones((n,), np.float32)
    u64 = np.uint64
    with np.errstate(over="ignore"):
        x = (u64(seed * 1_000_003 + 7_919) * u64(0x9E3779B97F4A7C15)
             + u64(rnd) * u64(0xBF58476D1CE4E5B9)
             + np.arange(n + 1, dtype=np.uint64) * u64(0x94D049BB133111EB))
        x ^= x >> u64(30)
        x *= u64(0xBF58476D1CE4E5B9)
        x ^= x >> u64(27)
        x *= u64(0x94D049BB133111EB)
        x ^= x >> u64(31)
    u = (x >> u64(11)).astype(np.float64) * 2.0 ** -53
    up = u[:n] < p
    if not up.any():
        up[int(u[n] * n)] = True
    return up.astype(np.float32)


class Follow:
    """The reference run of one cell from its seed: :meth:`rounds` runs
    rounds from the state, :meth:`evaluate` scores it.  ``tf32`` computes
    every product in TF32 (the control); ``fault`` plants one of
    'half_batch', 'no_exchange', 'answer' (a state left unchanged needs no
    run: it reads 1 by the change norms)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tf32=False, fault=None):
        self.cfg, self.traffic, self.device, self.fault = cfg, traffic, device, fault
        self.prod = Products(tf32)
        m = cfg["model"]
        self.n = cfg["n_nodes"]
        self.x, self.y, self.parts = inputs.images({**cfg["data"], "n_nodes": self.n}, seed,
                                                   device)
        self.n_test = cfg["data"]["n_test"]
        plan = inputs.gnlenet_plan(m)
        init = inputs.leaf_items(inputs.init_weights(plan, seed, device))
        self.names = [k for k, _ in init]
        self.shapes = [tuple(v.shape) for _, v in init]
        self.x0 = torch.cat([v.reshape(-1) for _, v in init])
        self.X = self.x0[None].repeat(self.n, 1)
        self.nbr, w, ws = circulant(self.n, cfg["degree"])
        self.nbr_t = torch.as_tensor(self.nbr, device=device)
        self.w = torch.as_tensor(w, device=device)
        self.w_self = torch.as_tensor(ws, device=device)
        self.batch_seed = inputs.sub_seed(seed, "batches", 31)
        self.key_seed = inputs.sub_seed(seed, "engine", 31) + 17
        self.bytes_sent, self.sim_time_s, self.recovery_bytes = 0.0, 0.0, 0.0
        self.groups = m["groups"]
        self.engine_seed = inputs.sub_seed(seed, "engine", 31)
        self.act = None

    def leaves(self, X):
        """Node-stacked views of a flat (n, P) block, by name."""
        out, off = {}, 0
        for name, shape in zip(self.names, self.shapes):
            k = int(np.prod(shape))
            a, b = name.split(".")
            out.setdefault(a, {})[b] = X[:, off:off + k].reshape(X.shape[0], *shape)
            off += k
        return out

    def change_norms(self):
        """Each leaf's norm of the change from the initial weights, over
        every node."""
        d = (self.X - self.x0[None]).double()
        out, off = {}, 0
        for name, shape in zip(self.names, self.shapes):
            k = int(np.prod(shape))
            out[name] = float(d[:, off:off + k].norm())
            off += k
        return out

    def node_change_norms(self):
        """Each node's norm of its change from the initial weights."""
        return (self.X - self.x0[None]).double().norm(dim=1).tolist()

    def local_steps(self, rnd: int):
        t = self.traffic
        idx = batch_indices([p for p in self.parts], self.batch_seed, rnd, t["local_steps"],
                            t["batch_size"])
        idx = torch.as_tensor(idx, device=self.device)
        lr = self.cfg["lr"]
        for s in range(idx.shape[0]):
            for lo in range(0, self.n, TRAIN_BLOCK):
                rows = idx[s, lo:lo + TRAIN_BLOCK]
                if self.fault == "half_batch":
                    rows = rows[:, :rows.shape[1] // 2]
                Xb = self.X[lo:lo + TRAIN_BLOCK].clone().requires_grad_(True)
                loss = gnlenet.node_losses(self.leaves(Xb), self.x[rows], self.y[rows],
                                           self.groups, self.prod).sum()
                (g,) = torch.autograd.grad(loss, Xb)
                if self.act is not None:  # a node that sits the round out keeps its weights
                    g = g * self.act_t[lo:lo + TRAIN_BLOCK, None]
                self.X[lo:lo + TRAIN_BLOCK] -= lr * g

    def share(self, rnd: int):
        """One gossip step; returns the bytes each node sent."""
        sharing = self.traffic["sharing"]
        n, p = self.X.shape
        deg = float(self.cfg["degree"])
        if self.traffic.get("secure"):
            out, nbytes = self.secure_share()
        elif sharing == "full":
            out = self.w_self[:, None] * self.X
            for k in range(self.nbr.shape[1]):
                out += self.w[:, k, None] * self.X[self.nbr_t[:, k]]
            nbytes = deg * p * 4
        elif sharing == "randomk":
            k = max(1, int(self.traffic["budget"] * p))
            rk = threefry.fold_in(threefry.key(self.key_seed), rnd)
            sel = torch.zeros((n, p), dtype=torch.bool, device=self.device)
            for lo in range(0, n, SHARE_BLOCK):
                ids = torch.arange(lo, min(lo + SHARE_BLOCK, n), device=self.device)[:, None]
                u = threefry.uniform(threefry.fold_in(rk, ids), p, self.device)
                top = torch.sort(u, dim=1, descending=True, stable=True).indices[:, :k]
                sel[lo:lo + ids.shape[0]].scatter_(1, top, True)
            out = self.X.clone()
            for lo in range(0, n, SHARE_BLOCK):
                blk = self.X[lo:lo + SHARE_BLOCK]
                for s in range(self.nbr.shape[1]):
                    j = self.nbr_t[lo:lo + SHARE_BLOCK, s]
                    out[lo:lo + SHARE_BLOCK] += (self.w[lo:lo + SHARE_BLOCK, s, None]
                                                 * torch.where(sel[j], self.X[j] - blk, 0.0))
            nbytes = deg * k * 8
        else:
            raise ValueError(f"unknown sharing {sharing!r}")
        if self.fault != "no_exchange":
            self.X = out
        return float(np.float32(nbytes))

    def secure_share(self):
        """Secure aggregation's result (paper §3.4): each live receiver
        averages itself with its live neighbours at equal weight
        1 / (1 + degree); the pairwise masks cancel, the seed-recovery pass
        removing those of the pairs whose other sender sat out, so the
        result is the plain aggregate of the live neighbours.  A node that
        sits out keeps its weights.  Bytes: every live edge carries the P
        values and 3% of metadata, over the live nodes, plus a 32-byte
        seed share for every (live receiver, live sender, dropped
        co-neighbour)."""
        n, p = self.X.shape
        a = self.act
        live = a[self.nbr]                                    # (N, D) senders up
        w = 1.0 / (1.0 + self.cfg["degree"])
        live_t = torch.as_tensor(live, device=self.device)
        total = torch.zeros_like(self.X)
        for k in range(self.nbr.shape[1]):
            total += live_t[:, k, None] * self.X[self.nbr_t[:, k]]
        deg_r = live_t.sum(1)
        wr = torch.where((self.act_t > 0) & (deg_r > 0), w, 0.0)
        out = (1.0 - wr * deg_r)[:, None] * self.X + wr[:, None] * total
        out = torch.where(self.act_t[:, None] > 0, out, self.X)
        f32 = np.float32
        edges = f32(np.count_nonzero(a[:, None] * live)) / f32(max(np.count_nonzero(a), 1))
        wire = edges * f32(f32(p * 4) * f32(1.03))
        rec = f32(np.sum(a * live.sum(1) * (1.0 - live).sum(1), dtype=f32)) * f32(32)
        self.recovery_bytes += float(rec)
        self.deg_eff = edges
        return out, wire + rec

    def rounds(self, start: int, count: int):
        p = self.traffic.get("participation", 1.0)
        if p < 1.0 and not self.traffic.get("secure"):
            raise NotImplementedError("churn is followed under secure aggregation only")
        for rnd in range(start, start + count):
            if p < 1.0:
                self.act = participation(self.engine_seed, rnd, self.n, p)
                self.act_t = torch.as_tensor(self.act, device=self.device)
            self.local_steps(rnd)
            nbytes = self.share(rnd)
            self.bytes_sent += nbytes
            if self.act is None:
                self.sim_time_s += lan_round_s(self.nbr, nbytes, float(self.cfg["degree"]))
            else:
                live = self.act[:, None] * self.act[self.nbr]
                self.sim_time_s += lan_round_s(self.nbr, nbytes, self.deg_eff, live)

    def evaluate(self):
        """(mean, std) over nodes of each node's test accuracy."""
        tx, ty = self.x[:self.n_test], self.y[:self.n_test]
        accs = torch.cat([gnlenet.node_accuracy(self.leaves(self.X[lo:lo + EVAL_BLOCK]), tx, ty,
                                                self.groups, self.prod)
                          for lo in range(0, self.n, EVAL_BLOCK)]).cpu().numpy()
        if self.fault == "answer":
            accs[0] = 1.0 - accs[0]
        return [float(accs.mean()), float(accs.std())]


def readings(cfg: dict, traffic: dict, seed: int, device, warm: int, tf32=False, fault=None):
    """The reference's readings of the set-up's warm steps: round 0 and
    its evaluation, then ``warm`` rounds and theirs."""
    ref = Follow(cfg, traffic, seed, device, tf32, fault)
    ref.rounds(0, 1)
    first, first_node = ref.change_norms(), ref.node_change_norms()
    acc = ref.evaluate()
    ref.rounds(1, warm)
    acc += ref.evaluate()
    out = {"first_change": first, "first_node": first_node, "change": ref.change_norms(),
           "node": ref.node_change_norms(),
           "acc": acc, "bytes": [ref.bytes_sent], "sim_time": [ref.sim_time_s]}
    if traffic.get("secure"):
        out["recovery_bytes"] = [ref.recovery_bytes]
    return out
