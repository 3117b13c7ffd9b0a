"""GN-LeNet — the paper's own CIFAR-10 workload (DecentralizePy §3.1).
Not part of the assigned pool; used by the faithful-reproduction
experiments and benchmarks."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name="gn-lenet", family="cnn", vocab=10, dtype="float32")


def smoke_config() -> ModelConfig:
    return config()


def supports_shape(shape: str):
    if shape == "train_4k":
        return True, ""
    return False, "CNN classifier: no sequence shapes"
