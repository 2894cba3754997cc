"""The port's training entry point, ``run_train_torch.main``, in-process on
the CPU at tiny size: a ShapeNet6D-format training tree of 4 pairs at
96 x 128 (``chip_smoke.write_shapenet6d_tree``, made with the port's
``synthetic_pair``), validation on a REAL275-format tree
(``chip_smoke.write_real275_tree``), two epochs, a checkpoint each, a resume
that continues step, optimizer and LR, a warm start, the JSONL log, and the
refusals.  The printed lines are ``run_train.py``'s: the fixed text of each
line is held against that file (running the JAX CLI itself at the sizes it
supports costs minutes of compilation).
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

from test_torch_run_test import _FakeTokenizer


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    import chip_smoke

    root = tmp_path_factory.mktemp("train_data")
    n = chip_smoke.write_shapenet6d_tree(str(root / "shapenet6d_t"), np.random.RandomState(0), 4,
                                         hw=(96, 128))
    chip_smoke.write_real275_tree(str(root / "nocs_v"), np.random.RandomState(2), "cpu",
                                  views=2, pairs=((0, 1), (1, 0)), scale=0.4)
    return str(root), n


def _args(root, tmp_path, *extra):
    import chip_smoke
    return [f"dataset.root={root}", "dataset.train.name=shapenet6d_t",
            f"dataset.train.split={chip_smoke.TRAIN_SPLIT}", "dataset.test.name=nocs_v",
            f"dataset.test.split={chip_smoke.EVAL_SPLIT}", "model.size=tiny",
            "dataset.batch_size=2", "dataset.img_size=[56,56]", "dataset.cache_gib=1",
            "training.freq_save=1", "training.freq_valid=2", "test.icp_points=128",
            "test.icp_iters=4", f"exp_root={tmp_path}", "exp_name=train", *extra,
            "--device", "cpu"]


def test_run_train_torch_main_on_the_cpu(trees, tmp_path, capsys, monkeypatch):
    import run_train_torch
    from oryon_tpu_torch.models import tokenizer
    from oryon_tpu_torch.train import cosine_lr

    monkeypatch.setattr(tokenizer, "ClipTokenizer", _FakeTokenizer)
    root, n = trees
    tr = run_train_torch.main(_args(root, tmp_path, "training.n_epochs=2"))
    out = capsys.readouterr().out
    lines = out.splitlines()
    models = tmp_path / "train" / "models"
    want = [f"TRAINING on shapenet6d_t, split train_split. Samples: {n}",
            "augmentations: on-device (color jitter + flips fused into the train step)",
            f"saved {models / 'epoch=0000'}", f"saved {models / 'epoch=0001'}",
            "WARNING: PointDSC snapshot absent; validating with RANSAC so pose metrics "
            "stay meaningful"]
    for w in want:
        assert w in lines, w
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert [e.split(":")[0] for e in epochs] == ["epoch 0", "epoch 1"]
    keys = [kv.split("=")[0] for kv in epochs[0].split(": ", 1)[1].split()]
    assert keys == ["train_loss/total", "train_loss/mask", "train_loss/pos", "train_loss/neg",
                    "train_metric/iou_a", "train_metric/iou_q"]
    assert all(np.isfinite(float(kv.split("=")[1])) for kv in epochs[1].split(": ", 1)[1].split())
    valid = [ln for ln in lines if ln.startswith("valid epoch 1: ")]
    assert len(valid) == 1 and "ADD(S)-0.1d=" in valid[0]
    assert tr.state.step == 2 * (n // 2)
    # the fixed text of every line is a string of run_train.py's
    with open(os.path.join(os.path.dirname(run_train_torch.__file__), "run_train.py")) as f:
        texts = {node.value for node in ast.walk(ast.parse(f.read()))
                 if isinstance(node, ast.Constant) and isinstance(node.value, str)}
    for text in ("TRAINING on ", ", split ", ". Samples: ", "Resumed from epoch ", "saved ",
                 "valid epoch ", "epoch ", want[1], want[4], "warm-started params from ",
                 " (fresh optimizer state / schedule)", "non-finite loss at step "):
        assert text in texts, text

    # the JSONL log: a train record each 10 steps, the epoch means, the validation
    with open(tmp_path / "train" / "logs" / "train.metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["epoch"] for r in recs if "epoch" in r] == [0, 1]
    assert [r["step"] for r in recs if "train_loss/total" in r and "epoch" not in r] == [1, 3]
    assert any("valid_metric_ADD(S)-0.1d" in r for r in recs)

    # resume: epoch 2 continues the step count, the optimizer and the LR
    tr = run_train_torch.main(_args(root, tmp_path, "training.n_epochs=3", "resume_ckpt=last"))
    out = capsys.readouterr().out
    assert "Resumed from epoch 1" in out and "epoch 2: " in out and "epoch 1: " not in out
    assert f"saved {models / 'epoch=0002'}" in out
    total = (n // 2) * 3
    assert tr.state.step == total
    assert tr.state.lr == cosine_lr(1e-3, total, 0.1)(total)
    assert tr.state.optimizer.param_groups[0]["lr"] == cosine_lr(1e-3, total, 0.1)(total - 1)
    counts = {st["count"] for st in tr.state.optimizer.state.values()}
    assert counts == {total}

    # a warm start takes the weights only
    tr = run_train_torch.main(_args(root, tmp_path, "training.n_epochs=1", "exp_name=warm",
                                    "init_params_from=train:1", "training.freq_valid=5"))
    out = capsys.readouterr().out
    assert f"warm-started params from {models / 'epoch=0001'} (fresh optimizer state / " \
           "schedule)" in out
    assert tr.state.step == n // 2

    with pytest.raises(ValueError, match="torchrun"):
        run_train_torch.main(_args(root, tmp_path, "mesh.data=4"))
    if not torch.cuda.is_available():
        args = _args(root, tmp_path)[:-2]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_train_torch.main(args)
