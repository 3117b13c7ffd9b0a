"""The yardstick's frozen counts pinned to hand-worked values, and every
cell of BENCHMARK.json resolving its files by name."""
import json
import math

import pytest

from portbench import common, counts

BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())
GNLENET = json.loads((common.BENCH / "configs" / "gnlenet-cifar10-n1024.json").read_text())
SMOLLM = json.loads((common.BENCH / "configs" / "smollm-135m-dpsgd-n8.json").read_text())


def test_gnlenet_forward_macs():
    # conv1 32*32*32*75 + conv2 16*16*64*800 + fc 4096*128 + 128*10
    assert counts.gnlenet_macs(GNLENET["model"]) == 2_457_600 + 13_107_200 + 524_288 + 1_280
    assert counts.gnlenet_macs(GNLENET["model"]) == 16_090_368


def test_gnlenet_chunk_flops():
    # 4 rounds x 16,384 samples x 3 x 2 x MACs, plus 1024 x 512 forwards
    want = 4 * 1024 * 2 * 8 * 6 * 16_090_368 + 1024 * 512 * 2 * 16_090_368
    assert counts.gnlenet_chunk_flops(GNLENET["model"], 1024, 2, 8, 4, 1, 512) == want


def test_smollm_parameters():
    assert counts.lm_params(SMOLLM["model"]) == 134_515_008


def test_smollm_step_flops():
    m = SMOLLM["model"]
    attn = 30 * 4 * 576 * 129 / 2
    assert counts.lm_step_flops(m, 8, 8, 128) == pytest.approx(
        3 * (2 * 134_515_008 + attn) * 8192, rel=1e-12)


@pytest.mark.parametrize("args,want", [
    # the gather merge at N=1024, K=6, P=579,594 and at (8, 134,515,008)
    ((1024, 6, 579_594, 4, 1024), (2 * 1024 * 579_594 * 4 + 1024 * 6 * 8) / 3.35e9),
    ((8, 6, 134_515_008, 4, 8), (2 * 8 * 134_515_008 * 4 + 8 * 6 * 8) / 3.35e9),
])
def test_merge_bound(args, want):
    assert counts.merge_bound_ms(*args) == pytest.approx(want, rel=1e-12)
    assert 1.4173 < counts.merge_bound_ms(1024, 6, 579_594, 4, 1024) < 1.4174


def test_payload_bound():
    # random-k 10%: X in and out, (1024, 57,959) idx and values, 5 slots
    want = (2 * 1024 * 579_594 * 4 + 1024 * 57_959 * 8 + 1024 * 5 * 8) / 3.35e9
    assert counts.payload_bound_ms(1024, 579_594, 1024, 57_959, 5) == pytest.approx(want)
    assert 1.5590 < want < 1.5591


def test_keyed_bound():
    # 5120 messages x 4 co-neighbour slots x 289,797 cipher lanes x 42
    # integer operations at 64 lanes x 132 SMs x 1980 MHz
    rate = counts.int32_rate(132, 1980.0)
    ms = counts.keyed_bound_ms(5120, 579_594, 5120 * 4 * 289_797, rate)
    assert ms == pytest.approx(5120 * 4 * 289_797 * 42 / rate * 1e3)
    assert 14.90 < ms < 14.91


def test_bound_takes_the_larger_time():
    assert counts.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert counts.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert counts.bound_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(cell):
    from portbench.run import cell_metrics, load_cell

    entry, cfg, traffic, limits = load_cell(BENCH, cell)
    assert (common.BENCH / "drivers" / f"{cfg['driver']}.py").is_file()
    assert limits and all(math.isfinite(v) and v >= 0 for v in limits.values())
    assert cfg["name"] == entry["config"] and traffic
    for trace in (False, True):
        for m in cell_metrics(BENCH, cell, trace):
            if trace:
                assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
            assert m["name"] in {e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert {m["name"] for m in cell_metrics(BENCH, cell, False)} >= {"setup_s", "rounds_per_s"}
    assert cell_metrics(BENCH, cell, True)


def test_benchmark_names_and_paths():
    assert BENCH["paths"] == ["portbench"]
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (common.ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        assert m["moves"] == "rounds_per_s"


def test_trace_busy_and_idle_gaps():
    # overlapping kernels count once in busy time; each gap is named by the
    # operation that ended last before it
    t = common.Trace.__new__(common.Trace)
    t.wall_s, t.steps = 1e-3, 1
    t.device = [("a", 0.0, 100.0), ("b", 50.0, 120.0), ("c", 150.0, 200.0),
                ("d", 500.0, 620.0), ("e", 510.0, 520.0)]
    assert t.busy_s == pytest.approx(290e-6)
    assert t.idle_gaps() == [["after c", pytest.approx(300e-6)], ["after b", pytest.approx(30e-6)]]
    assert t.kernel_ms(r"^[ab]$") == (pytest.approx(0.17), 2)
    assert t.top_ops(1) == [["d", pytest.approx(120e-6)]]
