"""The port's serving CLI (``run_infer_torch.py``) and ``load_view`` on the
CPU, at the small / tiny model sizes, from files written to ``tmp_path``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEPTH_HW, IMG_HW = (48, 64), (64, 64)
CAM = np.array([60.0, 0, 32.0, 0, 60.0, 24.0, 0, 0, 1], np.float32)
# the small model takes the real tokenizer's ids (tiny has 600 of them)
SMALL = ["model.size=small", f"dataset.img_size=[{IMG_HW[0]},{IMG_HW[1]}]",
         "test.solver=ransac", "test.n_corrs=64", "test.icp_points=128", "test.icp_iters=4"]


def _write_pair_files(tmp_path, rs, stem):
    from PIL import Image

    paths = {}
    for side in ("a", "q"):
        rgb = (rs.rand(*IMG_HW, 3) * 255).astype(np.uint8)
        depth = (rs.rand(*DEPTH_HW) * 300 + 600).astype(np.uint16)
        rp = tmp_path / f"{stem}_{side}.png"
        dp = tmp_path / f"{stem}_{side}_depth.png"
        Image.fromarray(rgb).save(rp)
        Image.fromarray(depth).save(dp)
        paths[side] = (str(rp), str(dp))
    return paths


def _check_pose(line):
    T = np.asarray(line["pose"])
    assert T.shape == (4, 4) and np.isfinite(T).all()
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-3)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1], atol=1e-6)
    assert isinstance(line["n_corrs"], int) and isinstance(line["detection_valid"], bool)


def test_run_infer_torch_cli_single_pair_from_a_checkpoint(tmp_path, capsys):
    """One pair from files, served from a checkpoint of the experiment: the
    line written to ``out=`` has ``run_infer.py``'s keys, and its pose is the
    one a predictor built directly on the saved weights gives (same request
    seed; 1e-3 rad, 1e-4 m)."""
    import run_infer_torch
    from _torch_helpers import rotation_angle
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor, load_view
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import small_oryon

    rs = np.random.RandomState(2)
    paths = _write_pair_files(tmp_path, rs, "pair0")
    overrides = SMALL + [f"exp_root={tmp_path}", "exp_name=infer_smoke", "eval.ckpt=last",
                         f"pretrained.pointdsc={tmp_path}/none"]
    cfg = tcfg.load_config(None, overrides)
    ckpt.init_experiment(cfg)
    saved = random_init_(small_oryon(), torch.Generator().manual_seed(9))
    ckpt.save_checkpoint(cfg, 6, saved)

    out = tmp_path / "pose.json"
    run_infer_torch.main([
        "--anchor-rgb", paths["a"][0], "--anchor-depth", paths["a"][1],
        "--query-rgb", paths["q"][0], "--query-depth", paths["q"][1],
        "--camera", "60,60,32,24", "--prompt", "mug", "--device", "cpu",
        *overrides, f"out={out}",
    ])
    printed = capsys.readouterr().out
    assert "loaded checkpoint epoch 6" in printed and "wrote 1 results" in printed
    lines = [json.loads(ln) for ln in open(out) if ln.strip()]
    assert len(lines) == 1
    assert set(lines[0]) == {"id", "prompt", "pose", "n_corrs", "detection_valid"}
    assert lines[0]["prompt"] == "mug" and lines[0]["id"] == "0"
    _check_pose(lines[0])

    direct = OryonPredictor(saved, None, device="cpu", batch_size=1, img_size=IMG_HW,
                            depth_hw=DEPTH_HW, solver="ransac", n_corrs=64, icp_points=128,
                            icp_iters=4, seed=0)
    views = [load_view({"rgb": paths[s][0], "depth": paths[s][1], "camera": "60,60,32,24"})
             for s in ("a", "q")]
    ref = direct.predict_pair(views[0], views[1], "mug")
    assert ref["n_corrs"] == lines[0]["n_corrs"]
    T, T_ref = np.asarray(lines[0]["pose"]), np.asarray(ref["pose"])
    assert rotation_angle(T[:3, :3], T_ref[:3, :3]) < 1e-3
    assert np.abs(T[:3, 3] - T_ref[:3, 3]).max() < 1e-4


def test_run_infer_torch_cli_requests_jsonl(tmp_path, capsys):
    """A JSONL stream of three pairs at batch size 2, random weights
    (``eval.ckpt=``): one line per request on the standard output, in order,
    ids kept; ``--device=cpu`` in its one-word form."""
    import run_infer_torch

    rs = np.random.RandomState(3)
    req_file = tmp_path / "reqs.jsonl"
    with open(req_file, "w") as f:
        for i in range(3):
            paths = _write_pair_files(tmp_path, rs, f"pair{i}")
            f.write(json.dumps({
                "anchor": {"rgb": paths["a"][0], "depth": paths["a"][1]},
                "query": {"rgb": paths["q"][0], "depth": paths["q"][1],
                          "camera": {"fx": 60, "fy": 60, "cx": 32, "cy": 24}},
                "camera": "60,60,32,24",
                "prompt": "bottle" if i else "mug",
                **({"id": f"req{i}"} if i else {}),
            }) + "\n\n")
    run_infer_torch.main([
        "--requests", str(req_file), "--device=cpu", *SMALL, "dataset.batch_size=2",
        f"exp_root={tmp_path}", "exp_name=infer_smoke2", "eval.ckpt=",
        f"pretrained.pointdsc={tmp_path}/none",
    ])
    results = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert [r["id"] for r in results] == ["0", "req1", "req2"]
    assert [r["prompt"] for r in results] == ["mug", "bottle", "bottle"]
    for r in results:
        _check_pose(r)


def test_run_infer_torch_cli_needs_a_camera_and_a_device():
    import run_infer_torch

    with pytest.raises(SystemExit, match="--camera"):
        run_infer_torch.main(["--anchor-rgb", "a.png", "--device", "cpu"])
    assert run_infer_torch._flag(["--prompt", "mug"], "--device", "cuda") == "cuda"


DEPTH = (np.arange(48 * 64, dtype=np.float32).reshape(48, 64) % 700) + 300.0


def _save_depth(tmp_path, form):
    from PIL import Image

    path = str(tmp_path / f"depth.{form}")
    if form == "png":
        Image.fromarray(DEPTH.astype(np.uint16)).save(path)
    elif form == "npy":
        np.save(path, DEPTH)
    else:
        np.savez(path, depth=DEPTH.astype(np.int32))
    return path


def _save_camera(tmp_path, form):
    if form == "inline":
        return "60,60,32,24"
    if form == "dict":
        return {"fx": 60, "fy": 60, "cx": 32, "cy": 24}
    path = tmp_path / f"cam.{form}"
    if form == "json":
        path.write_text(json.dumps({"K": CAM.tolist()}))
    else:
        path.write_text(" ".join(str(v) for v in CAM))
    return str(path)


def _save_mask(tmp_path, form):
    from PIL import Image

    mask = np.zeros(IMG_HW, np.uint8)
    mask[10:30, 20:40] = 255
    path = str(tmp_path / f"mask.{form}")
    if form == "png":
        Image.fromarray(mask).save(path)
    elif form == "rgb.png":
        Image.fromarray(np.stack([mask, 0 * mask, 0 * mask], -1)).save(path)
    elif form == "npy":
        np.save(path, mask.astype(np.int64) * 3)
    else:
        np.savez(path, m=mask)
    return path, (mask > 0).astype(np.uint8)


@pytest.mark.parametrize("depth,camera,mask", [
    ("png", "inline", None), ("npy", "json", "png"), ("npz", "txt", "rgb.png"),
    ("png", "dict", "npy"), ("npy", "inline", "npz")])
def test_load_view_forms_match_jax_package(tmp_path, depth, camera, mask):
    """Each depth, camera and mask form reads as the JAX package's
    ``load_view`` reads it: the same arrays, dtypes and keys."""
    from PIL import Image

    from oryon_tpu.infer import load_view as ref_fn
    from oryon_tpu_torch.infer import load_view

    rgb = (np.random.RandomState(5).rand(*IMG_HW, 3) * 255).astype(np.uint8)
    rgb_path = str(tmp_path / "rgb.jpg" if depth == "npz" else tmp_path / "rgb.png")
    Image.fromarray(rgb).save(rgb_path)
    spec = {"rgb": rgb_path, "depth": _save_depth(tmp_path, depth),
            "camera": _save_camera(tmp_path, camera)}
    want_mask = None
    if mask:
        spec["mask"], want_mask = _save_mask(tmp_path, mask)
    got, ref = load_view(spec), ref_fn(spec)
    assert set(got) == set(ref) == {"rgb", "depth", "camera"} | ({"mask"} if mask else set())
    for k in got:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["rgb"].dtype == np.uint8 and got["rgb"].shape == (*IMG_HW, 3)
    np.testing.assert_array_equal(got["depth"], DEPTH)
    np.testing.assert_array_equal(got["camera"], CAM)
    if mask:
        np.testing.assert_array_equal(got["mask"], want_mask)
