"""The port's evaluation loop and entry point against the JAX package's on
the CPU: ``run_test_epoch`` fed the same fixed pipeline outputs writes a
byte-equal prediction CSV and the same metrics; ``nn_correspondences_anchors``
gives the JAX argmins; the ``debug_valid`` path (ground-truth
correspondences) of the tiny model gives the JAX correspondences and poses;
``run_test_torch.main`` runs end to end at tiny size on a 480 x 640
REAL275-format tree (``chip_smoke.write_real275_tree``).
"""
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rotation_angle
from test_torch_data import nocs_root  # noqa: F401  (module fixture)
from test_torch_pipeline import (B, MAXC, _jax_batch, _noise_from_keys,  # noqa: F401
                                 _port_batch, _views, slice_models)


def _fake_outputs(batch_index, B_, anchor_pose, pkg):
    """Fixed outputs of one batch: poses near identity (some pairs with too
    few correspondences or no detection), IoUs and signal metrics."""
    rs = np.random.RandomState(100 + batch_index)
    rel = np.tile(np.eye(4, dtype=np.float32), (B_, 1, 1))
    rel[:, :3, 3] = rs.randn(B_, 3) * 0.01
    abs_ = np.einsum("bij,bjk->bik", rel, anchor_pose).astype(np.float32)
    n_corrs = rs.choice([0.0, 3.0, 40.0, 120.0], B_)
    det = (rs.rand(B_) > 0.2).astype(np.float32)
    packed = np.concatenate([rel.reshape(B_, 16), abs_.reshape(B_, 16), n_corrs[:, None],
                             det[:, None], rs.rand(B_, 5)], 1).astype(np.float32)
    if pkg == "jax":
        from oryon_tpu.pipeline import PipelineOutputs
        return PipelineOutputs(*(None,) * 10, packed=jnp.asarray(packed))
    from oryon_tpu_torch.pipeline import PipelineOutputs
    return PipelineOutputs(*(None,) * 10, packed=torch.from_numpy(packed), fmr=None,
                           inlier_rate=None, feat_ratio=None)


def test_run_test_epoch_writes_the_jax_csv(nocs_root):  # noqa: F811
    """Both loops over the same 5 pairs in batches of 2 (class-sorted, the
    last one padded), fed the same outputs: byte-equal CSVs, metrics within
    1e-6, the same failure counts and pair count."""
    from oryon_tpu.data.datasets import NocsReader as JReader, PairDataset as JDataset
    from oryon_tpu.eval.evaluator import BatchedEvaluator as JEval
    from oryon_tpu.pipeline import run_test_epoch as jrun
    from oryon_tpu_torch.data.datasets import NocsReader, PairDataset
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.pipeline import run_test_epoch

    from test_torch_data import _tokenizer
    results = {}
    for pkg in ("jax", "torch"):
        Reader, Dataset, Eval = ((JReader, JDataset, JEval) if pkg == "jax"
                                 else (NocsReader, PairDataset, BatchedEvaluator))
        ds = Dataset(Reader(nocs_root), "test_split", _tokenizer, max_corrs=32,
                     img_size=(56, 56))
        ev = Eval("Ours", render_hw=(60, 80), vsd_window=32)
        ev.add_object_info(ds.reader.object_info())
        ev.init_test()
        calls = []

        def fn(*args):
            batch = args[1] if pkg == "jax" else args[0]
            calls.append(1)
            return _fake_outputs(len(calls), len(batch.cls_id),
                                 np.asarray(batch.anchor.pose), pkg)
        csv = io.StringIO()
        if pkg == "jax":
            n = jrun(fn, ds, ev, 2, jax.random.PRNGKey(0), csv_fp=csv)
        else:
            n = run_test_epoch(fn, ds, ev, 2, csv_fp=csv)
        results[pkg] = (n, csv.getvalue(), ev.get_means(), ev.counts)
    (n_j, csv_j, m_j, c_j), (n_t, csv_t, m_t, c_t) = results["jax"], results["torch"]
    assert n_j == n_t == 5
    assert csv_t == csv_j and len(csv_t.splitlines()) == 5
    assert m_j.keys() == m_t.keys() and all(abs(m_j[k] - m_t[k]) < 1e-6 for k in m_j)
    assert c_j == c_t


def test_drain_errors_reach_the_caller(nocs_root):  # noqa: F811
    """An error while registering a batch stops the loop and is raised on
    the caller's thread."""
    from oryon_tpu_torch.data.datasets import NocsReader, PairDataset
    from oryon_tpu_torch.pipeline import run_test_epoch

    from test_torch_data import _tokenizer

    class Broken:
        metrics = {}

        def register_test_batch(self, *a, **kw):
            raise ValueError("scoring failed")

        def register_test_failure(self, *a, **kw):
            raise ValueError("scoring failed")

    ds = PairDataset(NocsReader(nocs_root), "test_split", _tokenizer, max_corrs=32,
                     img_size=(56, 56))
    with pytest.raises(ValueError, match="scoring failed"):
        run_test_epoch(lambda b, t: _fake_outputs(0, len(b.cls_id), b.anchor.pose.numpy(),
                                                  "torch"), ds, Broken(), 2)


def test_nn_correspondences_anchors_matches_jax():
    from oryon_tpu.ops.matching import nn_correspondences_anchors as jnn
    from oryon_tpu_torch.ops.matching import nn_correspondences_anchors

    rs = np.random.RandomState(3)
    f1, f2 = (rs.randn(2, 12, 16, 8).astype(np.float32) for _ in range(2))
    m2 = (rs.rand(2, 12, 16) > 0.4).astype(np.uint8)
    anchors = np.stack([rs.randint(0, 12, (2, 50)), rs.randint(0, 16, (2, 50))], -1)
    got = nn_correspondences_anchors(*(torch.from_numpy(a) for a in (f1, f2, anchors, m2)))
    for b in range(2):
        ref = jnn(jnp.asarray(f1[b]), jnp.asarray(f2[b]), jnp.asarray(anchors[b]),
                  jnp.asarray(m2[b]), chunk=64)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_debug_valid_matches_jax(slice_models):  # noqa: F811
    """Ground-truth correspondences in place of matching (tiny model,
    PointDSC, ICP): the same featmap-frame correspondences, poses within
    1e-3 rad and 1e-4 m, and the same packed scalars."""
    from oryon_tpu.ops.matching import MatchParams as JMatch
    from oryon_tpu.pipeline import PipelineConfig as JCfg, make_run_fn as jmake
    from oryon_tpu_torch.ops.matching import MatchParams
    from oryon_tpu_torch.pipeline import PipelineConfig, make_run_fn

    model, params, pd, pd_vars, tmodel, tpd_model = slice_models
    rs = np.random.RandomState(5)
    a, q = _views(rs), _views(rs)
    N = 40     # fewer rows than max_corrs: the rest is padding
    corrs = np.concatenate([rs.randint(8, 56, (B, N, 2)), rs.randint(8, 56, (B, N, 2))], -1)
    corrs = (corrs + rs.randint(-2, 3, corrs.shape)).astype(np.int32)   # injected noise
    cv = rs.rand(B, N) > 0.1
    text = rs.randn(B, 8, 48).astype(np.float32)
    key = jax.random.PRNGKey(4)
    icp = dict(icp_refine=True, icp_points=128, icp_iters=6, icp_trim=0.6)
    jb = _jax_batch(a, q)._replace(corrs=jnp.asarray(corrs), corr_valid=jnp.asarray(cv))
    ref = jax.jit(jmake(model, JCfg(solver="pointdsc", debug_valid=True,
                                    match=JMatch(max_corrs=MAXC), **icp), (pd, pd_vars)))(
        params, key, jb, jnp.asarray(text))
    tb = _port_batch(a, q)._replace(corrs=torch.from_numpy(corrs).long(),
                                    corr_valid=torch.from_numpy(cv))
    out = make_run_fn(tmodel, PipelineConfig(solver="pointdsc", debug_valid=True,
                                             match=MatchParams(max_corrs=MAXC), **icp),
                      tpd_model)(tb, torch.from_numpy(text),
                                 noise=_noise_from_keys(key, 32 * 32))
    np.testing.assert_array_equal(out.corr_valid.numpy(), np.asarray(ref.corr_valid))
    np.testing.assert_array_equal(out.corrs.numpy(), np.asarray(ref.corrs))
    np.testing.assert_array_equal(out.n_corrs.numpy(), np.asarray(ref.n_corrs))
    T, T_ref = out.pred_rel_pose.numpy(), np.asarray(ref.pred_rel_pose)
    assert rotation_angle(T[:, :3, :3], T_ref[:, :3, :3]).max() < 1e-3
    assert np.abs(T[:, :3, 3] - T_ref[:, :3, 3]).max() < 1e-4
    np.testing.assert_allclose(out.packed.numpy()[:, 32:], np.asarray(ref.packed)[:, 32:],
                               atol=1e-6)


class _FakeTokenizer:
    """Ids inside the tiny model's 600-token vocabulary."""

    def __init__(self, *a):
        pass

    def __call__(self, texts, context_length=77):
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [598] + [ord(c) % 500 + 1 for c in t][:context_length - 2] + [599]
            out[i, :len(ids)] = ids
        return out


def test_run_test_torch_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The CLI at tiny size on a 480 x 640 tree (2 classes, 4 pairs), VSD
    on (96 px window), RANSAC + ICP, from a checkpoint: the JAX CLI's lines,
    4 CSV lines of 5 fields, the metrics JSON with BatchedEvaluator's keys,
    the config record; a device mesh on one device evaluates there."""
    import chip_smoke
    import run_test_torch
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.models import tokenizer
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon

    monkeypatch.setattr(tokenizer, "ClipTokenizer", _FakeTokenizer)
    n = chip_smoke.write_real275_tree(str(tmp_path / "nocs_t"), np.random.RandomState(2),
                                      "cpu", views=2, pairs=((0, 1), (1, 0)), scale=0.4)
    args = [f"dataset.root={tmp_path}", "dataset.test.name=nocs_t",
            f"dataset.test.split={chip_smoke.EVAL_SPLIT}", "model.size=tiny",
            "dataset.batch_size=2", "dataset.img_size=[64,64]", "test.solver=ransac",
            "test.icp_points=128", "test.icp_iters=4", "eval.vsd_window=96",
            f"exp_root={tmp_path}", "exp_name=cli", "eval.ckpt=last", "dataset.cache_gib=1"]
    cfg = load_config(None, args)
    ckpt.init_experiment(cfg)
    ckpt.save_checkpoint(cfg, 2, random_init_(tiny_oryon(), torch.Generator().manual_seed(1)))
    sw = run_test_torch.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    for want in ("TESTING on nocs_t, split eval_split. Samples: 4", "loaded checkpoint epoch 2",
                 "box_1 &", "tall_1 &", "Ours &", "registered 4 pairs ->"):
        assert want in out, want
    assert n == 4 and sw.n == 4
    rows = open(sw.csv).read().splitlines()
    assert len(rows) == 4 and all(len(r.split(",")) == 5 for r in rows)
    ref = BatchedEvaluator("Ours")
    ref.init_test()
    saved = json.load(open(sw.json))
    assert set(saved) == set(ref.metrics) | set(ref.counts) and len(saved["VSD"]) == 4
    assert any(f.startswith("config_") for f in os.listdir(os.path.dirname(sw.csv)))
    # a mesh on a host of one device: one device, as run_test.py's
    # serving_mesh policy gives (no line printed)
    assert run_test_torch.prepare(load_config(None, args + ["mesh.data=4"]), "cpu").mesh is None
    assert "mesh" not in capsys.readouterr().out


def test_savers_and_step_profiler(tmp_path, nocs_root):  # noqa: F811
    """The mask and featmap savers write one file set a live pair / batch;
    the step profiler records its window and writes a trace and a table."""
    from oryon_tpu_torch.data.datasets import NocsReader, PairDataset
    from oryon_tpu_torch.pipeline import PipelineOutputs
    from oryon_tpu_torch.utils.profiling import StepProfiler
    from oryon_tpu_torch.utils.savers import make_featmap_saver, make_mask_saver

    from test_torch_data import _tokenizer
    ds = PairDataset(NocsReader(nocs_root), "test_split", _tokenizer, max_corrs=32,
                     img_size=(56, 56))
    batch = next(ds.batches(2))._replace(valid=np.array([1.0, 0.0], np.float32))
    m = torch.zeros((2, 8, 8), dtype=torch.uint8)
    out = PipelineOutputs(*(None,) * 6, mask_a=m, mask_q=m + 1,
                          corrs=torch.zeros((2, 4, 4), dtype=torch.int64),
                          corr_valid=torch.ones((2, 4), dtype=torch.bool),
                          packed=None, fmr=None, inlier_rate=None, feat_ratio=None)
    make_mask_saver(str(tmp_path / "masks"))(0, batch, out)
    make_featmap_saver(str(tmp_path / "feats"))(3, batch, out)
    assert len(os.listdir(tmp_path / "masks")) == 2     # the pad is skipped
    with np.load(tmp_path / "feats" / "featmaps_00003.npz") as z:
        assert z["mask_q"].max() == 1 and z["corrs"].shape == (2, 4, 4)
    prof = StepProfiler(True, str(tmp_path / "prof"), start=1, n_steps=2)
    for _ in range(4):
        torch.ones(64, 64) @ torch.ones(64, 64)
        prof.step()
    prof.close()
    assert {"steps.json", "steps.txt"} <= set(os.listdir(tmp_path / "prof"))
