from repro_torch.data.datasets import SyntheticImages, SyntheticLM, TeacherImages, make_dataset
from repro_torch.data.loader import NodeBatcher
from repro_torch.data.partition import sharding_partition
