"""The control on the card, at each cell's own size: the program in the
configuration's ``control`` precision (the nearest below the one it
states) must fail the committed limits, while the program as stated
passes them.  Needs a CUDA card (about three minutes a cell):

    python3 -m pytest -q -m gpu bench_h100/tests/test_bench_control_gpu.py
"""

import pytest
import torch

from bench_h100 import calibrate, check
from bench_h100.run import Spec
from bench_h100.tests.common import ROOT, bench

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    spec = Spec.load(bench(), cell, ROOT)
    got = calibrate.readings(spec, 2 ** 31 + 4242, ["sound", "control"])
    keys = list(spec.limits)
    sound = [(k, got["sound"][k]) for k in keys]
    control = [(k, got["control"][k]) for k in keys]
    assert check.judge(sound, spec.limits)[0], got["sound"]
    assert not check.judge(control, spec.limits)[0], got["control"]
