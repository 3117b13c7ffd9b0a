"""CPU-sized copies of the cells for the tests: the same drivers,
references and comparisons at widths and counts a test run holds (the
published widths run only on the card)."""
import json

from portbench import common

BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())


def cell(name: str):
    """(configuration, traffic, limits, end-to-end metric entries) of
    ``name`` cut to a CPU test's size."""
    from portbench.run import cell_metrics, load_cell

    _, cfg, traffic, limits = load_cell(BENCH, name)
    if cfg["driver"] == "engine":
        cfg.update(n_nodes=8, chunk_rounds=2)
        cfg["model"] = {**cfg["model"], "width": 8, "image": 16, "fc_hidden": 16}
        cfg["data"] = {**cfg["data"], "n_train": 256, "n_test": 32, "image_shape": [16, 16, 3]}
    else:
        cfg["model"] = {**cfg["model"], "num_hidden_layers": 2, "hidden_size": 48,
                        "intermediate_size": 96, "num_attention_heads": 6,
                        "num_key_value_heads": 2, "vocab_size": 256}
        cfg.update(chunk_steps=2)
        traffic = {**traffic, "batch": 2, "seq": 8, "draw_vocab": 64}
    return cfg, traffic, limits, cell_metrics(BENCH, name, False)
