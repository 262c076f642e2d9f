"""The control of each cell's checks, on the card at the cell's own size
(``python -m pytest portbench -m cuda``): the plain reference computed with
TF32 matrix products, put in the program's place, fails a check that the
program passes. Skips without a card."""

import pytest
import torch

import control
from benchlib import layout

CELLS = [w["name"] for w in layout.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = control.readings(name, 2 ** 31 + 77, 3.0)
    limits = layout.cell(name).workload["checks"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in limits), r
