from repro_torch.optim.optimizers import Optimizer, apply_updates, make_optimizer, sgd
