"""A run of each cell on the card comes out correct, with every
metric that BENCHMARK.json gives the cell.  Skips without a card."""
import pytest

from perfbench import run as run_mod
from perfbench.lib import common


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["serve-int8-b8", "serve-bf16-b1"])
def test_cell_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    common.set_environment()
    # the whole run length: a shorter window answers too few of the sampled requests
    seconds = common.manifest()["run_seconds"]
    line, checks = run_mod.run_cell(common.load_cell(name), 2 ** 31 + 99, seconds, trace)
    assert line["correct"], checks
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in common.cell_metrics(name, section, common.manifest())}
    assert want <= set(line["metrics"])
