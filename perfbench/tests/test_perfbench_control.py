"""The control, the reference one precision step lower in the program's
place, comes out not correct at a tiny size on the CPU (on the card the
same is read at the cells' own size by ``perfbench/control.py``)."""
import time

import pytest

from perfbench import control
from perfbench.tests.tiny import tiny_cell
from perfbench.traffic import serve_closed


@pytest.mark.parametrize("name", ["serve-int8-b8", "serve-bf16-b1"])
def test_control_fails_a_limit(name):
    cell = tiny_cell(name)
    data = serve_closed.run(cell, 99, 0.0, False, time.perf_counter(), device="cpu",
                            on_card=False, keep=True)
    data["seed"] = 99
    limits = cell["workload"]["limits"]
    program = data["checks"]
    assert all(program[k] <= limits[k] for k in program)
    ctl = control.control_numbers(cell, data, "cpu")
    assert any(ctl[k] > limits[k] for k in ctl)
    assert ctl["feat_err"] > limits["feat_err"]
