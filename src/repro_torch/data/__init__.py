from repro_torch.data.datasets import SyntheticImages, SyntheticLM, TeacherImages, make_dataset
from repro_torch.data.loader import NodeBatcher, node_batch_indices
from repro_torch.data.partition import classes_per_node, iid_partition, sharding_partition
