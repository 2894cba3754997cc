"""The counts against values worked out by hand."""
import pytest
import torch

from perfbench.counts import kernels, model, peaks
from perfbench.lib import common


def test_k1_bound_at_the_served_batch():
    # [16, 577, 3072] bf16: 75.6 MB of q|k|v and output over 3.35 TB/s
    ops, nbytes = kernels.k1(16, 577, 1024, 16)
    assert ops == 4 * 16 * 16 * 577 * 577 * 64
    assert kernels.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0226, abs=5e-5)
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.BF16_FLOPS    # bytes bound it


def test_k2_bound_counts_the_kept_targets():
    # 8 pairs x 5120 sources x 36864 targets, 40% excluded, 32 channels
    work = 8 * 5120 * 0.6 * 36864
    ops, nbytes = kernels.k2(work, 8, 5120, 36864, 32)
    assert kernels.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0586, abs=5e-5)
    assert ops / peaks.BF16_FLOPS > nbytes / peaks.HBM_BYTES_PER_S    # operations bound it


def test_clip_tower_flops_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.model import ClipVisionTower
    v = common.load_cell("serve-int8-b8")["config"]["model"]["vision"]
    with torch.device("meta"):
        tower = ClipVisionTower(v, quant=True)
        with FlopCounterMode(display=False) as fc:
            tower(torch.zeros(1, 336, 336, 3))
    by_hand = model.clip_vision_flops(336, 14, 1024, 24)
    assert fc.get_total_flops() == by_hand
    assert by_hand == pytest.approx(381.9e9, rel=1e-3)


@pytest.mark.parametrize("name", ["serve-int8-b8", "serve-bf16-b1"])
def test_request_flops_hold_both_towers_per_view(name):
    cfg = common.load_cell(name)["config"]
    one = model.request_flops(cfg, 1)
    clip = model.clip_vision_flops(336, 14, 1024, 24)
    assert 2 * clip < one < 3 * clip
    assert model.request_flops(cfg, 8) == pytest.approx(8 * one, rel=1e-6)
