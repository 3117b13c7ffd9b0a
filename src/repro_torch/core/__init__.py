from repro_torch.core.engine import DLConfig, RoundEngine
from repro_torch.core.faults import FaultPlan
from repro_torch.core.federated import FederatedRunner, FLConfig
from repro_torch.core.node import DecentralizedRunner, build_graph
from repro_torch.core.topology import Graph, PeerSampler, SparseTopology
