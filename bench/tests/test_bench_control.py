"""The controls on the card, through a whole run of each cell at its own
size: the plain reference one precision below the configuration's (TF32
for f32) in the program's place, serving the window's own requests and
sessions, must come out not correct by the run's own check and limits,
while the program's run is correct.  The benchmark's own runs never run
them; ``bench/control.py`` reads them on several seeds (PERF.md)."""
from __future__ import annotations

import io
import time

import pytest
import torch

from conftest import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["resnet50.q8.closed8",
                                  "starcoder2-3b.decode.closed8"])
def test_the_control_comes_out_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read there")
    from bench.harness import cell, spec
    c = spec.resolve(name, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    res = cell.measure(c, 2**31 + 11, 10.0, False, torch.device("cuda", 0),
                       time.perf_counter(), out=io.StringIO(),
                       err=io.StringIO(), control=True)
    assert res["correct"] is True, res["checks"]
    assert res["control"]["correct"] is False, res["control"]
