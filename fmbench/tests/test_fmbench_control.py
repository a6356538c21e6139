"""The control on the card: the plain reference computed on the card's
TF32 routes, in the program's place, has to come out not correct against
the reference at float32 (at a size a test run holds; `calibrate.py`
reads it at each cell's own size)."""

import pytest
import torch

from fmbench.calibrate import control
from fmbench.harness import Bench


@pytest.mark.card
@pytest.mark.parametrize("cell", ["stereo_rds.file_1",
                                  "stereo_live.live_1x"])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    got = control(Bench(), cell, 2 ** 31 + 21, 2.0, "cuda",
                  {"block_fm": 16384}, {"blocks": 24})
    assert got["fails"], got
