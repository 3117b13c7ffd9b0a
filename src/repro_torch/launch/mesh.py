"""Meshes and device constants, the port of the JAX package's
``launch/mesh.py`` for one NVIDIA H100.

``make_node_mesh`` is a 1-D ``torch.distributed`` ``DeviceMesh`` over the
visible cards.  ``make_production_mesh`` is the reference's logical
production layout (16 node slots, 2 x 16 with ``multi_pod``, and a
tensor-parallel ``model`` axis) with the model axis of size 1 and every
slot on one card: the node axis is the port's stacked (vmap) axis, as in
the engine and the trainer, so a dry run over it describes the
reference's D-PSGD program placed whole on one H100.  Importing this
module touches no device and starts no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# NVIDIA H100 SXM constants for the roofline model (NVIDIA's H100 data
# sheet, SXM part, dense rates without sparsity, at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12   # bf16 / fp16 tensor-core products
PEAK_FLOPS_TF32 = 495e12   # TF32 tensor-core products
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores: the port's fp32 products run
#                            without TF32 (torch's default for matmuls), as PERF.md §3 says
HBM_BW = 3.35e12           # bytes/s, HBM3
HBM_BYTES = 80e9           # device memory (data sheet: 80 GB)
NVLINK_BW = 450e9          # bytes/s per direction (NVLink 4: 900 GB/s bidirectional);
#                            the counterpart of the reference's ICI_BW


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A named grid of slots on one card: ``axis_names`` of sizes
    ``axis_sizes``, with the reference's ``mesh.axis_names``,
    ``mesh.shape[axis]`` and ``mesh.size``."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production layout on one card: node axes ("data")
    of 16 slots, or ("pod", "data") of 2 x 16, and a ``model`` axis of 1."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 1))
    return LogicalMesh(("data", "model"), (16, 1))


def _visible_devices(device=None) -> Tuple[str, int]:
    """(device type, devices visible) for ``device`` ('cpu' or 'cuda';
    None means the card, raising where there is none, as the engine's
    ``resolve_device``)."""
    from repro_torch.core.engine import resolve_device

    kind = resolve_device(device).type
    if kind == "cpu":
        return "cpu", 1
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu|cuda)")
    return "cuda", torch.cuda.device_count()


def make_node_mesh(n_devices: int = 0, axis: str = "nodes", device=None):
    """1-D ``DeviceMesh`` over the first ``n_devices`` visible cards (all,
    if 0) with a single node axis.  ``device=None`` means the card and
    raises where there is none; ``device='cpu'`` builds the mesh over the
    CPU, which counts as one device.  Where no process group is up, a
    one-process group is started from an in-memory store (nccl on the
    card, gloo on the CPU); a mesh over n > 1 cards takes a group of n
    processes, one per card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kind, visible = _visible_devices(device)
    n = n_devices or visible
    if visible < n:
        raise ValueError(
            f"mesh wants {n} devices but only {visible} are visible "
            "(the CPU counts as one)")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() < n:
        raise ValueError(f"mesh wants {n} devices but the process group has "
                         f"{dist.get_world_size()} ranks (one process per card)")
    return DeviceMesh(kind, torch.arange(n), mesh_dim_names=(axis,))


def node_axes(mesh) -> tuple:
    """Mesh axes that form the DL node dimension (everything except TP)."""
    names = mesh.axis_names if isinstance(mesh, LogicalMesh) else mesh.mesh_dim_names
    return tuple(a for a in names if a != "model")


def n_node_slots(mesh) -> int:
    """Slots on the node axes: the most DL nodes the mesh stacks."""
    if isinstance(mesh, LogicalMesh):
        return math.prod(mesh.shape[a] for a in node_axes(mesh))
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in node_axes(mesh))
