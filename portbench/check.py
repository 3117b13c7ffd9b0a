"""The comparison that decides ``correct``: the program's readings of
the warm steps against the plain reference's, each as one number held to
its limit (``checks/<workload>.json``).  Nothing here imports the
program."""
from __future__ import annotations

import math

import numpy as np

# a leaf whose reference change is under this share of the median leaf's
# moves by round-off alone (a bias under softmax, say) and is left out
STILL_LEAF = 1e-3


def leaf_gaps(prog: dict, ref: dict):
    """Each leaf's gap between the program's and the reference's norm of
    one change: |a - b| over the larger of b and the median leaf's b, over
    the leaves the reference moves (None where the leaves differ or a norm
    is not finite)."""
    names = sorted(ref)
    if sorted(prog) != names:
        return None
    b = np.array([ref[k] for k in names], np.float64)
    a = np.array([prog[k] for k in names], np.float64)
    med = float(np.median(b))
    keep = b >= STILL_LEAF * med
    if not keep.any() or not np.isfinite(a).all():
        return None
    return np.abs(a - b)[keep] / np.maximum(b[keep], med)


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    g = leaf_gaps(prog, ref)
    return math.inf if g is None else float(g.max())


def node_gaps(prog, ref):
    """Each entry's gap between the program's and the reference's norm
    (one per node): |a - b| over the larger of b and the median b (None
    where the counts differ or a norm is not finite)."""
    a, b = np.asarray(prog, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    if a.shape != b.shape or not b.size or not np.isfinite(a).all():
        return None
    return np.abs(a - b) / np.maximum(b, np.median(b))


def median_node_gap(prog, ref) -> float:
    """The median node's gap (:func:`node_gaps`): steady where a rare flip
    of a discrete choice (a max-pool winner, a ReLU at 0) moves a few
    nodes and every leaf downstream of it, or one small leaf's rounding
    grows over the rounds, while a lower precision moves every node."""
    g = node_gaps(prog, ref)
    return math.inf if g is None else float(np.median(g))


def rel_gap(a, b) -> float:
    """max |a - b| / |b| over matching entries (inf where a is not finite)."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    if a.shape != b.shape or not np.isfinite(a).all():
        return math.inf
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def abs_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    if a.shape != b.shape or not np.isfinite(a).all():
        return math.inf
    return float(np.max(np.abs(a - b)))


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for each limit ``<reading>_<how>``:
    the program's and the reference's ``<reading>`` compared by ``norms``
    (:func:`leaf_gap`), ``median`` (:func:`median_node_gap`), ``exact`` or
    ``rel`` (:func:`rel_gap`) or ``abs`` (:func:`abs_gap`)."""
    out = {}
    for name, limit in limits.items():
        reading, key = name.rsplit("_", 1)
        a, b = prog.get(reading), ref.get(reading)
        if a is None or b is None:
            value = math.inf
        elif key == "norms":
            value = leaf_gap(a, b)
        elif key == "median":
            value = median_node_gap(a, b)
        elif key in ("exact", "rel"):
            value = rel_gap(a, b)
        elif key == "abs":
            value = abs_gap(a, b)
        else:
            raise ValueError(f"unknown comparison for {name!r}")
        out[name] = {"value": value, "limit": limit}
    return out


def passed(numbers: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in numbers.values())
