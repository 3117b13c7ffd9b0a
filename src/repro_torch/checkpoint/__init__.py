from repro_torch.checkpoint.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_tree,
    save_checkpoint,
)
