# The JAX package's ``repro.core`` namespace, name for name.  The sharded
# forms (NodeShard, ShardedTopology, ShardedDense, mix_sparse_shmap,
# mix_circulant_shmap) keep the reference's names, but take the port's
# operands: a ``torch.distributed`` rank's block of the node axis where the
# reference takes a ``shard_map`` device mesh.
from repro_torch.core.topology import (
    Graph,
    PeerSampler,
    SparseTopology,
    build_permute_schedule,
    circulant_neighbor_table,
    circulant_offsets,
    decompose_slot_permutations,
    gather_rows,
    mh_weight_table,
    neighbor_table,
    random_regular_neighbors,
    sample_neighbor_slots,
)
from repro_torch.core.mixing import (
    NodeShard,
    PermuteSchedule,
    ShardedDense,
    ShardedTopology,
    apply_W,
    gossip_pair_avg,
    mix_circulant,
    mix_circulant_shmap,
    mix_dense,
    mix_fully,
    mix_payload,
    mix_payload_masked,
    mix_payload_strided,
    mix_sparse,
    mix_sparse_shmap,
    mixing_bytes_per_node,
)
from repro_torch.core.sharing import (
    ChocoSGD,
    FullSharing,
    QuantizedSharing,
    RandomKSharing,
    TopKSharing,
    edge_reweight,
    edge_reweight_sparse,
    make_sharing,
    participation_deg_eff,
    participation_reweight,
    participation_reweight_rows,
    participation_reweight_sparse,
    sparse_aggregate,
)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.network import (
    LinkSpec,
    Mapping,
    NetworkModel,
    gathered_round_times,
    node_round_times,
    paper_testbed,
    straggler_compute_times,
    wan_deployment,
)
from repro_torch.core.secure import SecureAggregation
from repro_torch.core.engine import DLConfig, RoundEngine, build_network
from repro_torch.core.steps import RoundSteps
from repro_torch.core.scheduler import (
    AsyncScheduler,
    LocalScheduler,
    Scheduler,
    SyncScheduler,
    make_scheduler,
)
from repro_torch.core.node import DecentralizedRunner, build_graph
from repro_torch.core.federated import FederatedRunner, FLConfig
