from repro_torch.utils.pytree import (
    segment_starts,
    tree_bytes,
    tree_leaves,
    tree_map,
    tree_map_with_path_names,
    tree_size,
    tree_unvector,
    tree_vector,
)
