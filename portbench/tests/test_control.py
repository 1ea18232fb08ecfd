"""The control: the reference in TF32 put in the program's place fails the
comparison that decides `correct` (the chip readings at the cells' own
sizes are in PERF.md; `calibrate.py --control` makes them)."""

import pytest
import torch

from tiny import CELLS, run
from portbench.reference.exact import tf32


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-20, 1.0 + 2**-12, -3.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 4_000_000_007])
def test_control_is_not_correct(name, seed):
    out = run(name, seed=seed, control=True)
    assert not out["correct"], out["checks"]
