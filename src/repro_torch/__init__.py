"""PyTorch/CUDA port of the DecentralizePy emulator (see ``repro`` for the
JAX reference)."""
from repro_torch.core.engine import DLConfig, RoundEngine
from repro_torch.core.faults import FaultPlan
