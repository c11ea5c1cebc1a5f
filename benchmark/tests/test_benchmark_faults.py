"""``correct`` comes out false when the timed path is broken underneath (``faults``), and
the control, the reference with float8 operands in the program's place, fails the cell's
limits. A run is driven on the CPU at a small size, past the look for a card."""

from __future__ import annotations

import pytest
import torch

from benchmark import registry, run
from benchmark.faults import planted
from benchmark.tests.tiny import tiny_cell

CELL_FAULTS = [("dmsr-study.train", "frozen"), ("dmsr-study.train", "half_batch"),
               ("dmsr-study.train", "stale_batch"),
               ("scannet-scene0010.train", "frozen"), ("scannet-scene0010.train", "half_batch"),
               ("scannet-scene0010.train", "stale_batch"),
               ("dmsr-study.view", "half_view"), ("dmsr-study.view", "altered"),
               ("dmsr-study.mani", "half_view"), ("dmsr-study.mani", "altered"),
               ("dmsr-study.mani", "no_exchange")]
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("name,fault", [cf for cf in CELL_FAULTS if cf[0] in CELLS])
def test_a_planted_fault_is_not_correct(name, fault):
    c = tiny_cell(name, width=32)
    assert c["limits"], f"no limits for {name}"
    sound = run.run_cell(c, 2 ** 31 + 11, 0.2, False, torch.device("cpu"))
    assert sound["correct"], sound["checks"]
    with planted(fault):
        res = run.run_cell(c, 2 ** 31 + 11, 0.2, False, torch.device("cpu"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The control at the flagship widths over a few rays: float8 operands."""
    c = tiny_cell(name, width=256, rays=128)
    driver = registry.driver(c["mix"]["kind"])(c["conf"], c["mix"], 2 ** 31 + 12,
                                               torch.device("cpu"))
    driver.setup()
    driver.unit()
    driver.release()
    numbers = driver.check("fp8")
    limits = {k: v for k, v in c["limits"].items() if not k.startswith("_")}
    assert any(numbers[k] > v for k, v in limits.items()), (numbers, limits)
