"""The port's offline tools (``oryon_tpu_torch/scripts/``) against the JAX
package's ``scripts/`` on the CPU, on the same files and inputs.

* ``make_pair_split``: ``pcd_correspondences`` equal to the JAX version; the
  CLI over a rendered REAL275-format tree writes byte-equal split files.
* ``compute_metrics`` and ``null_baselines``: metrics within 1e-6.
* the two sweeps, fed the same fixed pipeline outputs per pass as
  ``test_torch_run_test.py::test_run_test_epoch_writes_the_jax_csv``: rows
  within 1e-6, the same best epoch / variant.
* ``sift_baseline``: ``sift_match`` equal; the pose under the JAX draws
  within 1e-3 rad and 1e-4 m.

The file tools, ``check_vsd_vs_gl`` and the exporter: test_torch_scripts_files.py.
"""
import filecmp
import importlib
import importlib.util
import json
import os
import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rotation_angle
from test_torch_data import nocs_root  # noqa: F401  (module fixture)
from test_torch_run_test import _FakeTokenizer, _fake_outputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_script(name):
    return importlib.import_module(f"oryon_tpu_torch.scripts.{name}")


@pytest.fixture(scope="module")
def box_root(tmp_path_factory):
    """A rendered 480 x 640 REAL275-format tree (2 classes, 2 views each)."""
    import chip_smoke
    root = tmp_path_factory.mktemp("boxes")
    chip_smoke.write_real275_tree(str(root / "nocs_t"), np.random.RandomState(2), "cpu",
                                  views=2, pairs=((0, 1), (1, 0)), scale=0.4)
    return str(root)


def _box_args(box_root, *extra):
    return [f"dataset.root={box_root}", "dataset.test.name=nocs_t",
            "dataset.test.split=eval_split", "dataset.img_size=[64,64]",
            "dataset.batch_size=2", *extra]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert fa == fb and fa
    for f in fa:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


# ---- make_pair_split ------------------------------------------------------
def test_pcd_correspondences_match_jax():
    jmod, port = _jax_script("make_pair_split"), _port_script("make_pair_split")
    rs = np.random.RandomState(0)
    pa = rs.rand(600, 3) * 60
    flat_a = rs.choice(64 * 64, 600, replace=False)
    yx_a = np.stack([flat_a // 64, flat_a % 64], 1)
    th = 0.3
    rel = np.eye(4)
    rel[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    rel[:3, 3] = [10.0, -5.0, 30.0]
    pq = pa @ rel[:3, :3].T + rel[:3, 3] + rs.randn(600, 3) * 1.5   # about half within 2 mm
    flat_q = rs.choice(64 * 64, 600, replace=False)
    yx_q = np.stack([flat_q // 64, flat_q % 64], 1)
    for kw in ({}, dict(max_corrs=100, subsample=400, seed=3)):
        ref = jmod.pcd_correspondences(pa, yx_a, pq, yx_q, rel, **kw)
        got = port.pcd_correspondences(pa, yx_a, pq, yx_q, rel, **kw)
        assert 50 < len(ref) < 600
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tree", ["nocs_root", "box_root"])
def test_make_pair_split_cli_writes_the_jax_files(tree, request, tmp_path, capsys):
    """The fixture tree (random depths: few or no 3D matches) and the
    rendered one (every drawn pair kept)."""
    src = request.getfixturevalue(tree)
    name, want = ("nocs", None) if tree == "nocs_root" else ("nocs_t", 3)
    src_root = os.path.dirname(src) if tree == "nocs_root" else src
    trees = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        shutil.copytree(src_root, root)
        argv = [f"dataset.root={root}", f"dataset.test.name={name}", "split_name=made",
                "n_pairs=3", "pair_mode=any", "min_corrs=20" if want else "min_corrs=1"]
        if pkg == "jax":
            _jax_script("make_pair_split").main(argv)
        else:
            _port_script("make_pair_split").main(argv + ["--device", "cpu"])
        trees[pkg] = os.path.join(root, name, "fixed_split", "made")
    out = capsys.readouterr().out
    assert out.count("wrote ") == 2
    _same_tree(trees["jax"], trees["torch"])
    with open(os.path.join(trees["torch"], "annots.pkl"), "rb") as f:
        annots = pickle.load(f)
    if want:
        assert len(annots) == want and all(len(v["corrs"]) >= 20 for v in annots.values())


def test_tools_need_a_card_unless_told_otherwise():
    """``--device`` defaults to cuda and raises without a card: no silent
    fallback to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _port_script("train_pointdsc").main(["steps=1"])
    from oryon_tpu_torch.scripts._cli import device
    assert device(["--device=cpu"]).type == "cpu"


# ---- compute_metrics, null_baselines ---------------------------------------
def _write_csv(box_root, path):
    """Each split pair's ground-truth relative pose, a few of them moved."""
    from oryon_tpu_torch.data.datasets import NocsReader
    from oryon_tpu_torch.eval.evaluator import pred_pose_csv_line
    from test_torch_data import _tokenizer
    from oryon_tpu_torch.data.datasets import PairDataset
    ds = PairDataset(NocsReader(os.path.join(box_root, "nocs_t")), "eval_split", _tokenizer)
    rs = np.random.RandomState(4)
    with open(path, "w") as f:
        for i, (sa, ia, sq, iq, _, obj) in enumerate(ds.instances):
            rel = np.asarray(ds.rel_poses[i], np.float32).copy()
            rel[:3, 3] += rs.randn(3).astype(np.float32) * 0.01 * (i % 2)
            if i == 1:
                rel = np.zeros((4, 4), np.float32)   # a failed pair
            f.write(pred_pose_csv_line(f"{sa} {ia} {obj}", f"{sq} {iq} {obj}", 0.8, 0.7, rel))
        f.write(pred_pose_csv_line("9 9 none", "9 9 none", 0.5, 0.5, np.eye(4)))  # not in split


def test_compute_metrics_matches_jax(box_root, tmp_path, capsys):
    csv = str(tmp_path / "pred.csv")
    _write_csv(box_root, csv)
    argv = [csv, *_box_args(box_root, "compute_vsd=false")]
    _jax_script("compute_metrics").main(argv)
    with open(tmp_path / "pred_recomputed.json") as f:
        ref = json.load(f)
    ev = _port_script("compute_metrics").main(argv + ["--device", "cpu"])
    with open(tmp_path / "pred_recomputed.json") as f:
        got = json.load(f)
    out = capsys.readouterr().out
    assert out.count("WARNING: 1 CSV rows not found in the split") == 2
    assert set(got) == set(ref) and len(got["R error"]) == 4
    for k, v in ref.items():
        if k in ("cls_id", "instance_id"):
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
    assert ev.get_means()["ADD(S)-0.1d"] < 1.0


def test_null_baselines_match_jax(box_root, capsys):
    from oryon_tpu.config import load_config as jload
    from oryon_tpu.data.datasets import NocsReader as JReader, PairDataset as JDataset
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.datasets import NocsReader, PairDataset
    from test_torch_data import _tokenizer
    args = _box_args(box_root, "eval.vsd_window=96")
    jmod, port = _jax_script("null_baselines"), _port_script("null_baselines")
    root = os.path.join(box_root, "nocs_t")
    jds = JDataset(JReader(root), "eval_split", _tokenizer, img_size=(64, 64))
    ds = PairDataset(NocsReader(root), "eval_split", _tokenizer, img_size=(64, 64))
    for mode in ("identity", "gt"):
        ref = jmod.run_baseline(jload(None, args), jds, mode)
        got = port.run_baseline(load_config(None, args), ds, mode, "cpu")
        assert set(got) == set(ref) and "VSD" in got
        for k in ref:
            assert abs(got[k] - ref[k]) < 1e-6, (mode, k)
    res = port.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "NULL BASELINES on nocs_t/eval_split: 4 pairs" in out and "[gt] " in out
    gt = res["gt"]
    assert gt["ADD(S)-0.1d"] == gt["MSSD"] == gt["MSPD"] == gt["VSD"] == 1.0
    assert res["identity"]["ADD(S)-0.1d"] < 1.0


# ---- the sweeps ---------------------------------------------------------------
def _sweep_args(nocs_root, tmp_path, name):  # noqa: F811
    return [f"dataset.root={os.path.dirname(nocs_root)}",
            f"dataset.test.name={os.path.basename(nocs_root)}",
            "dataset.test.split=test_split", "model.size=tiny", "dataset.batch_size=2",
            "dataset.img_size=[56,56]", "compute_vsd=false", f"exp_root={tmp_path}",
            f"exp_name={name}"]


@pytest.fixture
def fake_sweeps(monkeypatch, tmp_path):
    """Both packages' sweeps on fixed pipeline outputs: the k-th pipeline to
    run gives batch b the outputs of ``_fake_outputs(100 k + b)``.
    The JAX side's model, state and checkpoints are stand-ins (its pipeline
    is faked); the port restores real tiny checkpoints."""
    from oryon_tpu import checkpoint as jckpt
    from oryon_tpu import pipeline as jpipe
    from oryon_tpu import train as jtrain
    from oryon_tpu.models import oryon as joryon
    from oryon_tpu.models import tokenizer as jtok
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import pipeline as pipe
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.models import tokenizer
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon

    def builder(pkg):
        passes = []   # pipelines that ran a batch (run_test_torch.prepare builds one idle)

        def build(*a, **kw):
            calls = []

            def run(*args, **kw):
                batch = args[1] if pkg == "jax" else args[0]
                if not calls:
                    passes.append(1)
                calls.append(len(passes))
                pose = np.asarray(batch.anchor.pose.cpu() if pkg == "torch"
                                  else batch.anchor.pose)
                return _fake_outputs(100 * calls[0] + len(calls), len(batch.cls_id), pose, pkg)
            return run
        return build

    monkeypatch.setattr(jpipe, "build_pipeline", builder("jax"))
    monkeypatch.setattr(jpipe, "make_text_cache", lambda *a: None)
    monkeypatch.setattr(joryon, "build_model", lambda *a, **k: None)
    monkeypatch.setattr(jtrain, "create_train_state",
                        lambda *a, **k: types.SimpleNamespace(params=None))
    monkeypatch.setattr(jckpt, "list_checkpoints", lambda cfg: [(0, "e0"), (1, "e1")])
    monkeypatch.setattr(jckpt, "restore_checkpoint",
                        lambda cfg, state, which: (state, 1 if which == "last" else int(which)))
    monkeypatch.setattr(jtok, "ClipTokenizer", _FakeTokenizer)
    monkeypatch.setattr(pipe, "build_pipeline", builder("torch"))
    monkeypatch.setattr(tokenizer, "ClipTokenizer", _FakeTokenizer)

    def save(nocs_root, name):  # noqa: F811
        cfg = load_config(None, _sweep_args(nocs_root, tmp_path, name))
        ckpt.init_experiment(cfg)
        for e in (0, 1):
            ckpt.save_checkpoint(cfg, e, random_init_(tiny_oryon(),
                                                      torch.Generator().manual_seed(e)))
    return save


def _table(tmp_path, name, prefix):
    d = tmp_path / name / "results"
    files = sorted(f for f in os.listdir(d) if f.startswith(prefix))
    with open(d / files[-1]) as f:
        return json.load(f)


def _rows_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, v in r.items():
            assert (g[k] == v) if isinstance(v, (str, int)) else abs(g[k] - v) < 1e-6, k


def test_sweep_checkpoints_matches_jax(nocs_root, tmp_path, fake_sweeps, capsys):  # noqa: F811
    fake_sweeps(nocs_root, "sweep")
    _jax_script("sweep_checkpoints").main(_sweep_args(nocs_root, tmp_path, "jaxsweep"))
    ref = _table(tmp_path, "jaxsweep", "ckpt_sweep_")
    res = _port_script("sweep_checkpoints").main(
        _sweep_args(nocs_root, tmp_path, "sweep") + ["--device", "cpu"])
    got = _table(tmp_path, "sweep", "ckpt_sweep_")
    out = capsys.readouterr().out
    assert out.count("WARNING: PointDSC snapshot absent; sweeping with RANSAC") == 2
    assert out.count("best epoch by ADD(S)-0.1d:") == 2 and '"epoch": 1' in out
    assert [r["epoch"] for r in got["rows"]] == [0, 1]
    _rows_close(got["rows"], ref["rows"])
    assert got["best_epoch"] == ref["best_epoch"] and got["config"] == ref["config"]
    assert res.rows == got["rows"] and len(res.seconds) == 2
    assert got["rows"][0] != got["rows"][1]     # the passes saw different outputs


def test_sweep_eval_hparams_matches_jax(nocs_root, tmp_path, fake_sweeps, capsys):  # noqa: F811
    fake_sweeps(nocs_root, "hp")
    variants = "--variants=;test.solver=ransac test.dist_th=0.4"
    _jax_script("sweep_eval_hparams").main(
        _sweep_args(nocs_root, tmp_path, "jaxhp") + ["eval.ckpt=last", variants])
    ref = _table(tmp_path, "jaxhp", "eval_hparams_")
    res = _port_script("sweep_eval_hparams").main(
        _sweep_args(nocs_root, tmp_path, "hp") + ["eval.ckpt=last", variants, "--device", "cpu"])
    got = _table(tmp_path, "hp", "eval_hparams_")
    out = capsys.readouterr().out
    assert "HPARAM SWEEP on nocs/test_split: 5 pairs, epoch 1, 2 variants" in out
    assert out.count("falls back to RANSAC") == 2 and out.count("best variant by") == 2
    assert [r["variant"] for r in got["rows"]] == ["default",
                                                   "test.solver=ransac test.dist_th=0.4"]
    _rows_close(got["rows"], ref["rows"])
    assert got["best_variant"] == ref["best_variant"] and got["config"] == ref["config"]
    assert res.epoch == 1


# ---- sift_baseline ------------------------------------------------------------
def _textured_pair(rs):
    from scipy.ndimage import gaussian_filter, shift
    img = gaussian_filter(rs.rand(120, 160, 3), (2, 2, 0))
    img = (img - img.min()) / (img.max() - img.min())
    moved = np.clip(shift(img, (4.0, 6.0, 0), order=1, mode="nearest"), 0, 1)
    mask = np.zeros((120, 160), np.uint8)
    mask[10:110, 10:150] = 1
    return img.astype(np.float32), mask, moved.astype(np.float32), mask.copy()


def test_sift_baseline_matches_jax(box_root, capsys):
    pytest.importorskip("cv2")
    from oryon_tpu.geometry.kabsch import ransac_kabsch
    from oryon_tpu.geometry.pcd import lift_pcd_at
    jmod, port = _jax_script("sift_baseline"), _port_script("sift_baseline")
    rs = np.random.RandomState(6)
    rgb_a, mask_a, rgb_q, mask_q = _textured_pair(rs)
    ref = jmod.sift_match(rgb_a, mask_a, rgb_q, mask_q)
    got = port.sift_match(rgb_a, mask_a, rgb_q, mask_q)
    assert len(ref) > 20
    np.testing.assert_array_equal(got, ref)

    # the pose from those matches on a tilted plane, under the JAX draws
    K = np.array([500.0, 0, 80, 0, 500.0, 60, 0, 0, 1], np.float32)
    yy, xx = np.mgrid[0:120, 0:160]
    depth_a = (600.0 + 0.5 * xx + 0.3 * yy).astype(np.float32)
    depth_q = (600.0 + 0.5 * (xx - 6) + 0.3 * (yy - 4)).astype(np.float32)
    item_a = {"depth": depth_a, "camera": K}
    item_q = {"depth": depth_q, "camera": K}
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    pa = lift_pcd_at(jnp.asarray(depth_a), jnp.asarray(K), jnp.asarray(ref[:, :2])) / 1000.0
    pq = lift_pcd_at(jnp.asarray(depth_q), jnp.asarray(K), jnp.asarray(ref[:, 2:])) / 1000.0
    w = ((pa[:, 2] > 0) & (pq[:, 2] > 0)).astype(jnp.float32)
    T_ref = np.asarray(ransac_kabsch(sub, pa, pq, w, match_err=0.01)[0])
    uniforms = torch.from_numpy(np.asarray(jax.random.uniform(sub, (512, 4))))[None]
    T = port.register_pair(item_a, item_q, got, uniforms, "cpu")
    assert rotation_angle(T[:3, :3], T_ref[:3, :3]) < 1e-3
    assert np.abs(T[:3, 3] - T_ref[:3, 3]).max() < 1e-4

    # the CLI over the box tree: every pair registered or failed, the summary
    ev = port.main(_box_args(box_root, "compute_vsd=false", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sift] " in out and len(ev.metrics["R error"]) == 4


def test_sift_match_names_a_missing_opencv(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        _port_script("sift_baseline").sift_match(np.zeros((8, 8, 3)), np.ones((8, 8)),
                                                 np.zeros((8, 8, 3)), np.ones((8, 8)))
