"""The port's file tools and ``check_vsd_vs_gl`` against the JAX package's
scripts on the CPU, and the JAX package's own file readers on the port's
files:

* ``convert_pretrained`` and the asset tools: identical npz, json and tree
  files.  ``check_vsd_vs_gl``: the same report.
* ``scripts/bootstrap_ci.py`` and ``scripts/train_curves.py`` run on the
  port's result JSON and ``metrics.jsonl``.
* ``scripts/export_params_npz.py``: an exported JAX experiment restores
  through ``checkpoint.restore_params_only``.
"""
import json
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import flax_params
from test_torch_data import nocs_root  # noqa: F401  (module fixture)
from test_torch_scripts import _jax_script, _port_script, _same_tree


# ---- file tools -------------------------------------------------------------
def test_convert_pretrained_writes_the_jax_npz(tmp_path, capsys):
    rs = np.random.RandomState(8)
    args = []
    for key in ("clip", "swin", "catseg"):
        sd = {f"{key}.w{i}": torch.from_numpy(rs.randn(3, i + 1).astype(np.float32))
              for i in range(3)}
        torch.save(sd, tmp_path / f"{key}.pt")
        args.append(f"{key}={tmp_path / f'{key}.pt'}")
    _jax_script("convert_pretrained").main(args + [f"out={tmp_path / 'jax'}"])
    _port_script("convert_pretrained").main(args + [f"out={tmp_path / 'port'}"])
    out = capsys.readouterr().out
    assert out.count("(3 tensors)") == 6
    for name in ("clip_vit_l14_336.npz", "swin_b.npz", "catseg.npz"):
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def _toyl_masks(root):
    from PIL import Image
    d = os.path.join(root, "split", "test", "000001", "mask_visib_per_obj")
    os.makedirs(d)
    rs = np.random.RandomState(9)
    for img in (0, 3):
        for gt in (0, 1):
            m = (rs.rand(12, 16) > 0.6).astype(np.uint8) * 255
            Image.fromarray(m).save(os.path.join(d, f"{img:06d}_{gt:06d}.png"))


def test_dataset_assets_write_the_jax_files(nocs_root, tmp_path, capsys):  # noqa: F811
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = root = str(tmp_path / pkg)
        shutil.copytree(nocs_root, root)
        _toyl_masks(root)
        mod = _jax_script("make_dataset_assets") if pkg == "jax" \
            else _port_script("make_dataset_assets")
        for cmd in ("detections", "models_info", "normals", "fix_toyl_masks"):
            mod.main([cmd, f"root={root}"])
    out = capsys.readouterr().out.replace(roots["jax"], "<root>").replace(roots["port"], "<root>")
    lines = out.split()
    assert lines[:4] == lines[4:] and int(lines[0]) > 0
    _same_tree(roots["jax"], roots["port"])


def test_synthetic_sn6d_writes_the_jax_tree(tmp_path, capsys):
    argv = ["n_objects=2", "views=3", "pairs_per_obj=2", "n_val_objects=1",
            "val_pairs_per_obj=2", "seed=1"]
    _jax_script("make_synthetic_sn6d").main(argv + [f"out={tmp_path / 'jax'}"])
    _port_script("make_synthetic_sn6d").main(argv + [f"out={tmp_path / 'port'}"])
    out = capsys.readouterr().out
    assert out.count("wrote 9 images") == 2
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_check_vsd_vs_gl_gives_the_jax_report(tmp_path):
    from oryon_tpu.eval.renderer import Mesh, pad_mesh, render_depth
    from tests.test_renderer_evaluator import icosphere
    V, F = icosphere(r=40.0)
    mesh = Mesh(*pad_mesh(V, F))
    K = np.array([[280.0, 0, 160], [0, 280.0, 120], [0, 0, 1]], np.float32)
    hw = (240, 320)
    t_gt = np.array([10.0, -5.0, 600.0], np.float32)
    th = np.radians(8.0)
    R_est = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                     np.float32)
    t_est = t_gt + np.array([4.0, 0, 12.0], np.float32)

    def gl(R, t):
        return np.asarray(render_depth(mesh, jnp.asarray(R), jnp.asarray(t), jnp.asarray(K),
                                       hw=hw))

    d_gt = gl(np.eye(3, dtype=np.float32), t_gt)
    d_test = d_gt.copy()
    d_test[d_test == 0] = 900.0
    dump = tmp_path / "view.npz"
    np.savez(dump, K=K, R_gt=np.eye(3, dtype=np.float32), t_gt=t_gt, depth_gt=d_gt,
             R_est=R_est, t_est=t_est, depth_est=gl(R_est, t_est), depth_test=d_test,
             vertices=V, faces=F)
    ref = _jax_script("check_vsd_vs_gl").main([str(dump)])[0]
    got = _port_script("check_vsd_vs_gl").main([str(dump), "--json", str(tmp_path / "r.json"),
                                                "--device", "cpu"])[0]
    for part in ("gt", "est"):
        for k in ("covered_both", "only_gl", "only_ours"):
            assert abs(got[part][k] - ref[part][k]) <= 2, (part, k)
        for k in ("mean_abs_mm", "max_abs_mm"):
            assert abs(got[part][k] - ref[part][k]) < 1e-2, (part, k)
    assert got["gt"]["max_abs_mm"] < 0.1 and got["vsd_recall_ours"] == ref["vsd_recall_ours"]
    assert abs(got["vsd_recall_delta"]) < 1e-6
    assert json.load(open(tmp_path / "r.json"))[0]["dump"] == str(dump)


# ---- the JAX package's file readers on the port's files ----------------------
def test_bootstrap_ci_and_train_curves_read_the_ports_files(tmp_path, capsys):
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.utils.logging import MetricLogger
    rs = np.random.RandomState(10)
    paths = []
    for arm in ("a", "b"):
        ev = BatchedEvaluator("Ours", compute_vsd=False)
        ev.add_object_info({})
        ev.init_test()
        for i in range(12):
            ev.register_test_failure(rs.rand(), rs.rand(), cls_id="c", instance_id=str(i))
        paths.append(str(tmp_path / f"{arm}.json"))
        with open(paths[-1], "w") as f:
            ev.save(f)
    report = _jax_script("bootstrap_ci").main(paths + ["--metrics", "Mean IoU", "Anchor IoU",
                                                       "--n-boot", "200"])
    assert set(report) == {"Mean IoU", "Anchor IoU"} and report["Anchor IoU"]["n"] == 12

    log = MetricLogger(str(tmp_path / "logs"), "run")
    for step in range(3):
        log.log_step(step, {"loss/total": 1.0 / (step + 1)}, prefix="train")
    log.epoch_summary(0)
    log.close()
    capsys.readouterr()
    _jax_script("train_curves").main(log.path)
    out = capsys.readouterr().out
    assert "steps logged: 3" in out and "| 0 | 0.6111 |" in out


# ---- scripts/export_params_npz.py -------------------------------------------------
def test_exported_jax_experiment_restores_into_the_port(tmp_path, capsys):
    from oryon_tpu import checkpoint as jckpt
    from oryon_tpu.config import Config as JConfig
    from oryon_tpu.models.oryon import tiny_oryon as jtiny
    from oryon_tpu_torch.checkpoint import restore_params_only
    from oryon_tpu_torch.config import Config
    from oryon_tpu_torch.models.convert import from_jax_params
    from oryon_tpu_torch.models.oryon import tiny_oryon
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jcfg = JConfig(exp_root=str(tmp_path), exp_name="jaxrun")
    jckpt.init_experiment(jcfg)
    trees = {}
    for epoch in (0, 1):
        trees[epoch] = params = flax_params(jtiny(), 20 + epoch, z, z,
                                            jnp.zeros((1, 8, 16), jnp.int32))
        jckpt.save_checkpoint(jcfg, epoch, types.SimpleNamespace(
            params=params, opt_state={"count": np.zeros((), np.int32)},
            step=np.asarray(epoch, np.int32)))
    written = _jax_script("export_params_npz").main([f"exp_root={tmp_path}",
                                                     "exp_name=jaxrun"])
    assert [os.path.basename(os.path.dirname(p)) for p in written] == ["epoch=0000",
                                                                        "epoch=0001"]
    model = tiny_oryon()
    cfg = Config(exp_root=str(tmp_path), exp_name="other")
    path = restore_params_only(cfg, model, "jaxrun:1")
    assert path.endswith("epoch=0001")
    want = from_jax_params(trees[1])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # one entry by its path
    again = _jax_script("export_params_npz").main([written[0].rsplit("/", 1)[0]])
    assert again == [written[0]] and "wrote" in capsys.readouterr().out
