from repro_torch.training.trainer import (
    TrainConfig,
    init_node_params,
    make_node_train_step,
    make_train_step,
    stack_node_params,
)
