"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell at a tiny size on the CPU (the card
check skipped, everything else as on the card) with one answer altered
where the program produces it, and sees ``correct`` false and the number
that catches it over its limit; the unbroken run comes out correct."""
import pytest
import torch

from perfbench import run as run_mod
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242


def _run(name, trace=False):
    line, checks = run_mod.run_cell(tiny_cell(name), SEED, 1.0, trace, device="cpu")
    return line, {c["name"]: c for c in checks}


@pytest.mark.parametrize("name", ["serve-int8-b8", "serve-bf16-b1"])
@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_run_is_correct(name, trace):
    line, checks = _run(name, trace)
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["metrics"]


def test_altered_matches_fail(monkeypatch):
    import oryon_tpu_torch.ops.matching as matching
    real = matching.masked_argmin

    def shifted(src, tgt, bad, precision="bf16"):
        d, arg = real(src, tgt, bad, precision)
        return d, (arg + 7) % tgt.shape[1]

    monkeypatch.setattr(matching, "masked_argmin", shifted)
    line, checks = _run("serve-int8-b8")
    assert not line["correct"] and not checks["match_gap"]["ok"]


def test_altered_features_fail(monkeypatch):
    from oryon_tpu_torch.models.decoder import StandardDecoder
    real = StandardDecoder.forward

    def noisy(self, x, guidance):
        logits, feat = real(self, x, guidance)
        return logits, feat + 0.3 * feat.std() * torch.randn_like(feat)

    monkeypatch.setattr(StandardDecoder, "forward", noisy)
    line, checks = _run("serve-bf16-b1")
    assert not line["correct"] and not checks["feat_err"]["ok"]


def test_altered_pose_fails(monkeypatch):
    import oryon_tpu_torch.pipeline as pipeline
    real = pipeline.masked_icp

    def moved(*args, **kw):
        T = real(*args, **kw).clone()
        T[:, 0, 3] += 0.01          # 1 cm
        return T

    monkeypatch.setattr(pipeline, "masked_icp", moved)
    line, checks = _run("serve-int8-b8")
    assert not line["correct"] and not checks["icp_gap_mm"]["ok"]


def test_altered_solver_confidence_fails(monkeypatch):
    from oryon_tpu_torch.models import pointdsc
    real = pointdsc.NonLocalNet.forward

    def noisy(self, *args, **kw):
        feat = real(self, *args, **kw)
        return feat + 0.01 * feat.std() * torch.randn_like(feat)

    monkeypatch.setattr(pointdsc.NonLocalNet, "forward", noisy)
    line, checks = _run("serve-bf16-b1")
    assert not line["correct"] and not checks["pointdsc_conf_err"]["ok"]


@pytest.mark.parametrize("left_out", ["pairs", "rows"])
def test_correspondences_left_out_fail(monkeypatch, left_out):
    """The second half of the batch's pairs, or every second row of each
    pair, marked invalid where the matches are produced."""
    import oryon_tpu_torch.pipeline as pipeline
    real = pipeline.nn_correspondences

    def halved(*args, **kw):
        corr = real(*args, **kw)
        valid = corr.valid.clone()
        if left_out == "pairs":
            valid[valid.shape[0] // 2:] = False
        else:
            valid[:, 1::2] = False
        return corr._replace(valid=valid)

    monkeypatch.setattr(pipeline, "nn_correspondences", halved)
    line, checks = _run("serve-int8-b8")
    assert not line["correct"] and not checks["match_set_errors"]["ok"]
