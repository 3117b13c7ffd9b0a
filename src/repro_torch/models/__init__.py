from repro_torch.models.api import cross_entropy
from repro_torch.models.cnn import GNLeNet, cnn_apply, cnn_init
