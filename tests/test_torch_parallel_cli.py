"""The port's CLIs over several ranks: ``run_train_torch.main`` and
``run_test_torch.main`` on 2 gloo ranks on the CPU (``_torch_dist.cli_suite``)
against the same commands in one process, at tiny size.

Training (2 steps of B=2 with device augmentation, plain SGD, then a resume
for 2 more): the logged losses within rel 1e-5 and the checkpoints within
the update bound of ``test_torch_parallel.py`` (each data rank draws the
augmentation of the global batch and keeps its row; the gradients are
summed over the ranks).  Evaluation (PointDSC + ICP over 8 pairs, B=2):
rank 0 writes the CSV of the single process, byte for byte.
"""
import json

import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_helpers import default_threads
from test_torch_parallel import _update_error


def _train_args(root, exp_root, exp_name, *extra):
    import chip_smoke
    return [f"dataset.root={root}", "dataset.train.name=shapenet6d_t",
            f"dataset.train.split={chip_smoke.TRAIN_SPLIT}", "dataset.test.name=none",
            "model.size=tiny", "dataset.batch_size=2", "dataset.img_size=[56,56]",
            "optimization.optim_type=SGD", "optimization.lr=0.01", "training.freq_save=1",
            f"exp_root={exp_root}", f"exp_name={exp_name}", *extra, "--device", "cpu"]


def _test_args(root, exp_root, exp_name):
    import chip_smoke
    return [f"dataset.root={root}", "dataset.test.name=nocs_p",
            f"dataset.test.split={chip_smoke.EVAL_SPLIT}", "model.size=tiny",
            "dataset.batch_size=2", "dataset.img_size=[64,64]",
            f"pretrained.pointdsc={root}/pointdsc", "test.icp_points=128", "test.icp_iters=4",
            "compute_vsd=false", f"exp_root={exp_root}", f"exp_name={exp_name}",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run's results and the single-process run's, with paths."""
    import chip_smoke
    import run_test_torch
    import run_train_torch
    from oryon_tpu_torch.models import tokenizer

    root = tmp_path_factory.mktemp("cli_data")
    chip_smoke.write_shapenet6d_tree(str(root / "shapenet6d_t"), np.random.RandomState(0), 4,
                                     hw=(96, 128))
    chip_smoke.write_real275_tree(str(root / "nocs_p"), np.random.RandomState(2), "cpu",
                                  views=2, pairs=((0, 1), (1, 0), (0, 0), (1, 1)), scale=0.4)
    # PointDSC, the configured solver, from a native.npz of random weights
    from oryon_tpu_torch.models.convert import convert_pointdsc, save_flax_npz
    from oryon_tpu_torch.pipeline import pointdsc_native_path
    (root / "pointdsc").mkdir()
    save_flax_npz(pointdsc_native_path(str(root / "pointdsc")),
                  convert_pointdsc(chip_smoke._fake_pointdsc_snapshot(np.random.RandomState(11))))
    exp = tmp_path_factory.mktemp("cli_exp")
    args = dict(train_args=_train_args(root, exp, "dp", "training.n_epochs=1"),
                resume_args=_train_args(root, exp, "dp", "training.n_epochs=2",
                                        "resume_ckpt=last"),
                test_args=_test_args(root, exp, "dp_test"))
    ranks = td.Ranks(2, "cli_suite", args, tmp_path_factory.mktemp("cli"), timeout=240)
    with pytest.MonkeyPatch().context() as mp:
        mp.setattr(tokenizer, "ClipTokenizer", td.FakeTokenizer)
        with default_threads():
            run_train_torch.main(_train_args(root, exp, "one", "training.n_epochs=1"))
            run_train_torch.main(_train_args(root, exp, "one", "training.n_epochs=2",
                                             "resume_ckpt=last"))
        sw = run_test_torch.main(_test_args(root, exp, "one_test"))
    return exp, ranks.result(), sw


def _losses(exp, name):
    rows = [json.loads(line) for line in open(exp / name / "logs" / f"{name}.metrics.jsonl")]
    return [(r["step"], r["train_loss/total"]) for r in rows if "step" in r]


def test_dp_training_cli_logs_the_single_process_losses(runs):
    exp, res, _ = runs
    assert res["train_mesh"] == {"data": 2, "model": 1}
    assert res["train_step"] == 2 and res["resume_step"] == 4
    got, ref = _losses(exp, "dp"), _losses(exp, "one")
    assert [s for s, _ in got] == [s for s, _ in ref] and len(ref) == 2   # step 1 of each epoch
    for (_, g), (_, r) in zip(got, ref):
        assert g == pytest.approx(r, rel=1e-5)


@pytest.mark.parametrize("epoch", [0, 1])
def test_dp_training_cli_writes_the_single_process_checkpoint(runs, epoch):
    """Rank 0 writes the checkpoint; model, optimizer state and step are
    those of the single process (the weights within the update bound, with
    test_torch_train's 1e-7 gradient floor at LR 0.01)."""
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon

    exp, _, _ = runs
    path = f"models/epoch={epoch:04d}/state.pt"
    got = torch.load(exp / "dp" / path, weights_only=True)
    ref = torch.load(exp / "one" / path, weights_only=True)
    assert got["step"] == ref["step"] == 2 * (epoch + 1)
    assert got["model"].keys() == ref["model"].keys()
    init = random_init_(tiny_oryon(), torch.Generator().manual_seed(load_config(None, []).seed))
    before = {k: v.numpy() for k, v in init.state_dict().items()}
    assert _update_error({k: v.numpy() for k, v in got["model"].items()}, before,
                         {k: v.numpy() for k, v in ref["model"].items()}, floor=1e-9) <= 0
    assert got["optimizer"]["param_groups"] == ref["optimizer"]["param_groups"]


def test_dp_eval_cli_writes_the_single_process_csv(runs):
    _, res, sw = runs
    assert res["test_n"] == sw.n == 8
    assert open(res["csv"], "rb").read() == open(sw.csv, "rb").read()
