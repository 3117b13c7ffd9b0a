from repro_torch.core.engine import DLConfig, RoundEngine
from repro_torch.core.topology import Graph, SparseTopology
