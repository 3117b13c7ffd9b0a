from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size, tree_unvector, tree_vector
