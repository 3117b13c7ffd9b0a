"""The plain references held against the program at a CPU size: the
engine's full and random-k rounds (N = 16, width 8, round 0 and one chunk
of 2) and a 2-layer SmolLM-shaped trainer (step 0 and one chunk of 2),
from the same seeds, every compared number near round-off (the change
norms within 1e-3: the LM's norm weights, which start at 1, move by a
few ulps of 1 a step)."""
import pytest

from portbench import check, common, tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program(name):
    cfg, traffic, limits, _ = tiny.cell(name)
    driver = common.load_file(common.BENCH / "drivers" / f"{cfg['driver']}.py",
                              f"driver_{cfg['driver']}")
    cell = driver.Cell(cfg, traffic, 2 ** 33 + 5, "cpu")
    ref = driver.reference(cfg, traffic, 2 ** 33 + 5, "cpu")
    numbers = check.compare(cell.readings, ref, limits)
    for k, v in numbers.items():
        assert v["value"] <= (1e-3 if "change" in k else 1e-5), (k, v)
    assert numbers["bytes_exact"]["value"] == 0.0 if "bytes_exact" in numbers else True
