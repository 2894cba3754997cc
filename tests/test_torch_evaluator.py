"""The port's evaluators (``oryon_tpu_torch/eval/evaluator.py``) against the
JAX package's on the CPU, given the same registrations: two object classes
(one with a symmetry set) of a few hundred points and a 128-face mesh,
60 x 80 frames, a 32 px VSD window.  Means within 1e-6, the same JSON keys,
the same failure counts and LaTeX rows, byte-equal CSV lines.
"""
import io
import json

import numpy as np
import pytest
import torch

from test_torch_renderer import _poses, icosphere

HW, WINDOW = (60, 80), 32
K = np.array([[80.0, 0, 40], [0, 80.0, 30], [0, 0, 1]], np.float32)
SYM = {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}


def _objects(pkg):
    """{class: ObjectInfo} of one package: a sphere-like mesh per class."""
    if pkg == "jax":
        from oryon_tpu.data.bop import sym_set_from_info
        from oryon_tpu.eval.evaluator import ObjectInfo
        from oryon_tpu.eval.renderer import pad_mesh
    else:
        from oryon_tpu_torch.data.bop import sym_set_from_info
        from oryon_tpu_torch.eval.evaluator import ObjectInfo
        from oryon_tpu_torch.eval.renderer import pad_mesh
    out = {}
    for name, r, info in (("mug", 20.0, {}), ("can", 15.0, SYM)):
        V, F = icosphere(r=r)
        out[name] = ObjectInfo(V, 2 * r, sym_set_from_info(info, 0.05), pad_mesh(V, F))
    return out


def _registrations(seed=0):
    """One batch of 6 scored pairs (a zero pose, a failed pose, a wild pose
    whose render overflows the window among them) and two failures."""
    rs = np.random.RandomState(seed)
    n = 6
    R, t = _poses(n, seed)
    gt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gt[:, :3, :3] = R
    gt[:, :3, 3] = np.stack([rs.uniform(-0.03, 0.03, n), rs.uniform(-0.02, 0.02, n),
                             rs.uniform(0.35, 0.5, n)], 1)
    pred = gt.copy()
    pred[:, :3, 3] += rs.randn(n, 3).astype(np.float32) * [0.004, 0.004, 0.01]
    pred[1, :3, :3] = _poses(1, seed + 7)[0][0]
    pred[4, :3, 3] = [0.0, 0.0, 0.09]           # close to the camera: overflows
    rel = pred.copy()
    rel[2] = 0.0                                # zero pose -> identity
    rel[3] = np.eye(4)                          # failed pose
    depth = np.full((n,) + HW, 600.0, np.float32) + rs.randn(n, *HW).astype(np.float32)
    return dict(iou_a=rs.rand(n), iou_q=rs.rand(n), gt=gt, pred=pred, rel=rel,
                cls=["mug", "can", "mug", "can", "mug", "mug"],
                cams=np.tile(K, (n, 1, 1)), depth=depth, ids=[f"p{i}" for i in range(n)])


def _evaluator(pkg, batched, compute_vsd=True):
    if pkg == "jax":
        from oryon_tpu.eval.evaluator import BatchedEvaluator, Evaluator
    else:
        from oryon_tpu_torch.eval.evaluator import BatchedEvaluator, Evaluator
    ev = (BatchedEvaluator if batched else Evaluator)(
        "Ours", compute_vsd=compute_vsd, render_hw=HW, vsd_window=WINDOW)
    ev.add_object_info(_objects(pkg))
    ev.init_test()
    return ev


def _fill(ev, pkg, batched, reg):
    sel = [0, 1, 2, 3, 4, 5]
    if batched:
        depths = reg["depth"] if pkg == "jax" else torch.from_numpy(reg["depth"])
        ev.register_test_batch(reg["iou_a"], reg["iou_q"], reg["gt"], reg["pred"], reg["rel"],
                               reg["cls"], reg["cams"], depths if ev.compute_vsd else None,
                               reg["ids"], depth_index=None if pkg == "jax" else np.asarray(sel))
    else:
        for i in sel:
            ev.register_test(reg["iou_a"][i], reg["iou_q"][i], gt_pose=reg["gt"][i],
                             pred_pose=reg["pred"][i], pred_pose_rel=reg["rel"][i],
                             camera=reg["cams"][i],
                             depth=reg["depth"][i] if ev.compute_vsd else None,
                             cls_id=reg["cls"][i], instance_id=reg["ids"][i])
    ev.register_test_failure(0.2, 0.1, cls_id="mug", instance_id="f0")
    # one signal row per live pair, as the test loop registers them
    sig = np.linspace(0.0, 1.0, 8)
    ev.register_signal(sig > 0.5, sig, sig[::-1])
    ev.register_test_failure(0.3, 0.4, cls_id="can", instance_id="f1")


@pytest.mark.parametrize("compute_vsd", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_evaluator_matches_jax(batched, compute_vsd, capsys):
    """Same registrations, same summaries: means within 1e-6 (VSD included,
    the overflowing pose's recall zeroed by both), equal JSON keys and lists
    of ids, equal failure counts and LaTeX rows."""
    reg = _registrations()
    evs = {}
    for pkg in ("jax", "torch"):
        evs[pkg] = _evaluator(pkg, batched, compute_vsd)
        _fill(evs[pkg], pkg, batched, reg)
    ref, got = evs["jax"], evs["torch"]
    m_ref, m_got = ref.get_means(), got.get_means()
    assert m_ref.keys() == m_got.keys()
    for k in m_ref:
        assert abs(m_ref[k] - m_got[k]) < 1e-6, (k, m_ref[k], m_got[k])
    assert ref.counts == got.counts
    assert sum(got.counts["Missing segm"]) == 2 and sum(got.counts["Failed pose"]) == 1
    assert sum(got.counts["Zero pose"]) == 1
    assert ref.test_summary() == got.test_summary()
    assert ref.get_latex_str() == got.get_latex_str()
    if compute_vsd:
        # the wild pose's row: after the two failures when the batch is
        # flushed at the summary, in registration order otherwise
        assert 0 < m_got["VSD"] < 1 and got.metrics["VSD"][6 if batched else 4] == 0.0
    dumps = []
    for ev in (ref, got):
        f = io.StringIO()
        ev.save(f)
        dumps.append(json.loads(f.getvalue()))
    assert dumps[0].keys() == dumps[1].keys()
    assert dumps[0]["instance_id"] == dumps[1]["instance_id"]
    assert dumps[0]["cls_id"] == dumps[1]["cls_id"]
    for k, v in dumps[0].items():
        if not k.endswith("id"):
            np.testing.assert_allclose(np.asarray(dumps[1][k], float), np.asarray(v, float),
                                       atol=1e-6, err_msg=k)
    if batched and compute_vsd:
        out = capsys.readouterr().out
        assert "WARNING: 1 predicted pose(s) project outside" in out


@pytest.mark.parametrize("batched", [True, False])
def test_window_too_small_for_the_gt_pose_raises(batched):
    """A GT projection wider than the VSD window is a configuration error in
    both packages."""
    reg = _registrations(1)
    reg["gt"][:, :3, 3] = [0.0, 0.0, 0.08]     # 40 mm sphere at 80 mm: 40 px
    for pkg in ("jax", "torch"):
        ev = _evaluator(pkg, batched)
        with pytest.raises(RuntimeError, match="VSD render window too small"):
            _fill(ev, pkg, batched, reg)
            ev.get_means()


def test_csv_lines_are_byte_equal():
    from oryon_tpu.eval.evaluator import pred_pose_csv_line as jline
    from oryon_tpu_torch.eval.evaluator import pred_pose_csv_line

    reg = _registrations(2)
    for i in range(6):
        for pose in (reg["rel"][i], np.eye(4)):
            args = ("1 0 mug_1", "2 0 mug_1", float(np.float32(reg["iou_a"][i])),
                    float(reg["iou_q"][i]), pose)
            assert pred_pose_csv_line(*args) == jline(*args)


def test_per_pair_and_batched_agree():
    """The port's two evaluators give the same rows for the same pairs."""
    reg = _registrations(3)
    evs = [_evaluator("torch", b) for b in (True, False)]
    for ev, b in zip(evs, (True, False)):
        _fill(ev, "torch", b, reg)
    a, b = evs[0].get_means(), evs[1].get_means()
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) < 1e-6 for k in a)


def test_scoring_on_a_perfect_pose():
    """The GT pose as the prediction: R/t errors ~0 (f32 arccos), ADD(S),
    MSSD, MSPD and VSD recalls 1; a prediction 5 cm off scores lower."""
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator

    reg = _registrations(4)
    keep = [0, 5]
    ev = BatchedEvaluator("Ours", render_hw=HW, vsd_window=WINDOW)
    ev.add_object_info(_objects("torch"))
    ev.init_test()
    gt = reg["gt"][keep]
    ev.register_test_batch(np.ones(2), np.ones(2), gt, gt, gt, ["mug", "mug"], reg["cams"][keep],
                           reg["depth"][keep], ["a", "b"])
    m = ev.get_means()
    assert m["R error"] < 0.03 and m["T error"] == 0.0
    assert m["ADD(S)-0.1d"] == m["MSSD"] == m["MSPD"] == m["VSD"] == 1.0
    off = gt.copy()
    off[:, 0, 3] += 0.05
    ev.init_test()
    ev.register_test_batch(np.ones(2), np.ones(2), gt, off, off, ["mug", "mug"],
                           reg["cams"][keep], reg["depth"][keep], ["a", "b"])
    m = ev.get_means()
    assert m["T error"] == pytest.approx(5.0, abs=1e-4) and m["MSSD"] < 1.0
