"""On the card, at each cell's own size: the program's numbers fall within
their limits and each control that the cell's limits file names (the
reference in TF32 with int4 codes; in TF32 with the int8 codes kept, where
the cell has an f32 path to read) fails at least one. Run on the H100 with
``python -m pytest -q -m card edgebench/tests/test_edgebench_card.py``."""
import time

import pytest

from edgebench import check, harness
from edgebench.reference.arith import CONTROLS

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    res = harness.run_cell(cell, 2 ** 31 + 101, 2.0, False, device=card,
                           setup_t0=time.time(), with_control=True, log=lambda s: None)
    limits = check.load_limits(cell)
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    program = {k: v for k, v in numbers.items() if k.split(".")[0] not in CONTROLS}
    assert check.verdict(program, limits)[0], program
    assert set(check.load_controls(cell)) <= set(CONTROLS)
    for name in check.load_controls(cell):
        control = {k[len(name) + 1:]: v for k, v in numbers.items() if k.split(".")[0] == name}
        assert control and not check.verdict(control, limits)[0], (name, control)
