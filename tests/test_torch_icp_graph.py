"""``masked_icp`` split into steps (``oryon_tpu_torch.geometry.kabsch``): on
CPU tensors it takes the eager loop, which gives bitwise the poses of the
loop as it was written before the split (``_torch_helpers.parent_masked_icp``),
degenerate pairs included, and counts each call while spans are on.  The
CUDA-graph path is held to the eager loop in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from _torch_helpers import icp_inputs, parent_masked_icp
from oryon_tpu_torch.geometry import kabsch
from oryon_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _spans_off():
    profiling.set_spans(False)
    profiling.take_spans()
    profiling.take_counters()
    yield
    profiling.set_spans(False)
    profiling.take_spans()
    profiling.take_counters()


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("iters,trim", [(8, 0.7), (48, 0.6)])
def test_eager_icp_gives_the_bits_of_the_loop_before_the_split(P, iters, trim):
    inputs = icp_inputs(P, 96, 80, seed=10 + P)
    got = kabsch.masked_icp(*inputs, iters=iters, trim=trim)
    want = parent_masked_icp(*inputs, iters=iters, trim=trim)
    assert got.dtype == torch.float32 and got.shape == (P, 4, 4)
    assert torch.equal(got, want)
    # the refinement did something: some pose moved off its start
    assert not torch.equal(got, inputs[4])


@pytest.mark.parametrize("kind", ["mixed", "invalid"])
def test_pairs_with_fewer_than_4_valid_points_keep_their_start(kind):
    """Pair 1 has 3 valid source points and pair 2 no valid target point
    ("mixed"), or no cloud has a valid point ("invalid"): those pairs keep
    init_T, and every pose is the loop's bits."""
    inputs = icp_inputs(4, 64, 64, seed=3, kind=kind)
    got = kabsch.masked_icp(*inputs, iters=8, trim=0.6)
    assert torch.equal(got, parent_masked_icp(*inputs, iters=8, trim=0.6))
    kept = [1, 2] if kind == "mixed" else [0, 1, 2, 3]
    assert torch.equal(got[kept], inputs[4][kept])
    if kind == "mixed":
        assert not torch.equal(got[[0, 3]], inputs[4][[0, 3]])


def test_eager_icp_counts_each_call_while_spans_are_on():
    inputs = icp_inputs(2, 32, 32, seed=5)
    kabsch.masked_icp(*inputs, iters=2)
    assert profiling.take_counters() == {}
    profiling.set_spans(True)
    kabsch.masked_icp(*inputs, iters=2)
    kabsch.masked_icp(*inputs, iters=3, trim=0.6)
    assert profiling.take_counters() == {"icp_eager": 2}


def test_pipeline_refines_through_the_name_pipeline_masked_icp(monkeypatch):
    """``_icp_refine_pose`` looks ``masked_icp`` up in ``pipeline`` when it
    runs, so a fault planted there (the benchmark's moved pose) reaches the
    served pose."""
    from oryon_tpu_torch import pipeline
    from oryon_tpu_torch.data.pair_batch import PairView

    assert pipeline.masked_icp is kabsch.masked_icp
    calls = []

    def moved(*args, **kw):
        calls.append(kw)
        T = kabsch.masked_icp(*args, **kw).clone()
        T[:, 0, 3] += 0.01
        return T

    monkeypatch.setattr(pipeline, "masked_icp", moved)
    rs = np.random.RandomState(0)
    B, FH, FW, Ho, Wo = 2, 8, 8, 24, 32
    cam = torch.tensor([[300.0, 0, Wo / 2, 0, 300.0, Ho / 2, 0, 0, 1]] * B)

    def view(seed):
        depth = torch.from_numpy(np.random.RandomState(seed).uniform(600, 800, (B, Ho, Wo))
                                 .astype(np.float32))
        return PairView(rgb=None, mask=None, depth=None, orig_depth=depth, eval_depth=None,
                        camera=cam, pose=torch.eye(4).expand(B, 4, 4),
                        size=torch.tensor([[Ho, Wo]] * B))

    mask = torch.ones(B, FH, FW, dtype=torch.uint8)
    noise = [torch.from_numpy(rs.rand(B, FH * FW).astype(np.float32)) for _ in range(2)]
    T = torch.eye(4).repeat(B, 1, 1)
    n_corrs = torch.tensor([10.0, 2.0])
    cfg = pipeline.PipelineConfig(icp_refine=True, icp_points=32, icp_iters=3,
                                  icp_trim=0.6)
    out = pipeline._icp_refine_pose(noise[0], noise[1], T, n_corrs, mask, mask,
                                    view(1), view(2), (FH, FW), cfg)
    assert calls == [{"iters": 3, "trim": 0.6}]
    assert float(out[0, 0, 3] - T[0, 0, 3]) != 0.0   # pair 0 took the refined pose
    assert torch.equal(out[1], T[1])                  # pair 1 (< 4 corrs) kept T
