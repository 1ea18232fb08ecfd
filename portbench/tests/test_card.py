"""Each cell end to end on the card at a tiny size, traced, with the
control beside it (the CUDA kernels have no CPU mode). On the card:
`python3 -m pytest --noconftest -m cuda portbench/tests/test_card.py`."""

import pytest
import torch

from tiny import CELLS, cell, harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name):
    import time

    out = harness.run_cell(cell(name), 2**31 + 99, 0.5, True, cuda, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["platform"] == "gpu"
    ctl = harness.run_cell(cell(name), 2**31 + 98, 0.5, False, cuda, time.perf_counter(), control=True)
    assert not ctl["correct"], ctl["checks"]
