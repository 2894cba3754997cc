"""The port's checkpoints and experiment folder (``oryon_tpu_torch/checkpoint.py``)
and ``OryonPredictor.from_config`` serving from them, at tiny_oryon widths on
the CPU: the port's own ``state.pt`` entries, and a checkpoint written by the
JAX package with orbax and exported to ``params.npz``.
"""
import os
import types

import numpy as np
import pytest
import torch

from _torch_helpers import export_params_npz, flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "config.yaml")
B, IMG, DEPTH_HW = 2, 64, (48, 64)
TINY = ["model.size=tiny", f"dataset.batch_size={B}", f"dataset.img_size=[{IMG}, {IMG}]",
        "test.n_corrs=64", "test.solver=ransac", "test.icp_refine=false"]


def _cfg(tmp_path, exp="exp", extra=()):
    from oryon_tpu_torch import config as tcfg

    return tcfg.load_config(YAML, TINY + [f"exp_root={tmp_path}", f"exp_name={exp}",
                                          f"pretrained.pointdsc={tmp_path}/none", *extra])


def _model(seed):
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon

    return random_init_(tiny_oryon(), torch.Generator().manual_seed(seed)).eval()


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    rgb_a, rgb_q = ((rs.rand(B, IMG, IMG, 3) * 255).astype(np.uint8) for _ in range(2))
    ids = rs.randint(1, 590, (B, 8, 16)).astype(np.int32)
    ids[:, :, 7] = 599
    return rgb_a, rgb_q, ids


def test_from_config_restores_a_checkpoint_of_the_jax_package(tmp_path, capsys):
    """A tiny_oryon tree saved by the JAX package's ``save_checkpoint`` and
    exported to ``params.npz``: ``from_config`` with ``eval.ckpt=last`` (its
    own init seed plays no part) gives the JAX model's forward on the same
    inputs within 2e-4 absolute / relative, the bound of
    tests/test_torch_models.py for this model."""
    import jax
    import jax.numpy as jnp

    from oryon_tpu import checkpoint as jckpt
    from oryon_tpu.config import Config as JConfig
    from oryon_tpu.models.oryon import tiny_oryon as jtiny
    from oryon_tpu_torch.infer import OryonPredictor

    jmodel = jtiny()
    z = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    params = flax_params(jmodel, 11, z, z, jnp.zeros((1, 8, 16), jnp.int32))
    jcfg = JConfig(exp_root=str(tmp_path), exp_name="jaxrun")
    jckpt.init_experiment(jcfg)
    state = types.SimpleNamespace(params=params, opt_state={"count": np.zeros((), np.int32)},
                                  step=np.asarray(4, np.int32))
    entry = jckpt.save_checkpoint(jcfg, 2, state)

    cfg = _cfg(tmp_path, "jaxrun", ["eval.ckpt=last", "use_seed=true", "seed=5"])
    with pytest.raises(ValueError, match="params.npz"):   # raw orbax: not skipped
        OryonPredictor.from_config(cfg, device="cpu")
    assert export_params_npz(entry).endswith("epoch=0002/params.npz")
    capsys.readouterr()
    pred = OryonPredictor.from_config(cfg, depth_hw=DEPTH_HW, device="cpu")
    assert "loaded checkpoint epoch 2" in capsys.readouterr().out

    rgb_a, rgb_q, ids = _inputs(12)
    ref = jax.jit(jmodel.apply)(params, jnp.array(rgb_a), jnp.array(rgb_q), jnp.array(ids))
    with torch.inference_mode():
        got = pred.model(*(torch.from_numpy(a) for a in (rgb_a, rgb_q, ids)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4, rtol=2e-4)


def test_save_restore_round_trip_is_exact(tmp_path):
    """Model, optimizer state and step come back bit for bit, by "last" and
    by number; saving an epoch again replaces it; no temporary entry stays."""
    from oryon_tpu_torch import checkpoint as ckpt

    cfg = _cfg(tmp_path)
    ckpt.init_experiment(cfg)
    model = _model(0)
    opt = torch.optim.Adam(model.decoder.parameters(), lr=1e-3)
    sum(p.square().sum() for p in model.decoder.parameters()).backward()
    opt.step()
    path = ckpt.save_checkpoint(cfg, 1, model, opt, step=7)
    assert path == os.path.abspath(os.path.join(ckpt.ckpt_dir(cfg), "epoch=0001"))
    assert os.listdir(path) == ["state.pt"]
    later = _model(1)
    ckpt.save_checkpoint(cfg, 3, later)
    assert [e for e, _ in ckpt.list_checkpoints(cfg)] == [1, 3]
    assert sorted(os.listdir(ckpt.ckpt_dir(cfg))) == ["epoch=0001", "epoch=0003"]

    fresh = _model(2)
    assert ckpt.restore_checkpoint(cfg, fresh, "last") == (3, 0) and _same(fresh, later)
    fresh_opt = torch.optim.Adam(fresh.decoder.parameters(), lr=1e-3)
    assert ckpt.restore_checkpoint(cfg, fresh, "1", fresh_opt) == (1, 7) and _same(fresh, model)
    want, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert set(got) == set(want) and len(got) > 0
    for k in want:
        assert torch.equal(got[k]["exp_avg"], want[k]["exp_avg"])
        assert torch.equal(got[k]["exp_avg_sq"], want[k]["exp_avg_sq"])

    ckpt.save_checkpoint(cfg, 1, later)          # the same epoch again
    assert ckpt.restore_checkpoint(cfg, fresh, 1)[0] == 1 and _same(fresh, later)


@pytest.mark.parametrize("stray", ["epoch=0003.orbax-checkpoint-tmp-1", "epoch=0004.tmp-77",
                                   "epoch=5x", "notes.txt"])
def test_list_checkpoints_ignores_what_is_not_an_entry(tmp_path, stray):
    """A half-written entry of either package is not restored."""
    from oryon_tpu_torch import checkpoint as ckpt

    cfg = _cfg(tmp_path)
    assert ckpt.list_checkpoints(cfg) == []          # no models directory yet
    ckpt.init_experiment(cfg)
    ckpt.save_checkpoint(cfg, 2, _model(0))
    os.makedirs(os.path.join(ckpt.ckpt_dir(cfg), stray))
    assert [e for e, _ in ckpt.list_checkpoints(cfg)] == [2]
    assert ckpt.restore_checkpoint(cfg, _model(1), "last")[0] == 2


def test_nothing_to_restore_and_missing_epoch(tmp_path, capsys):
    """No checkpoint: epoch -1, the model untouched, and ``from_config``
    prints the JAX package's warning and serves its current weights.  A
    number that is not there raises."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch.infer import OryonPredictor

    cfg = _cfg(tmp_path, "empty", ["eval.ckpt=last"])
    model, twin = _model(3), _model(3)
    assert ckpt.restore_checkpoint(cfg, model, "last") == (-1, 0) and _same(model, twin)
    pred = OryonPredictor.from_config(cfg, depth_hw=DEPTH_HW, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
    out = capsys.readouterr().out
    assert ("WARNING: eval.ckpt='last' not found; serving current "
            "(pretrained/random) params") in out
    assert _same(pred.model, twin)

    ckpt.init_experiment(cfg)
    ckpt.save_checkpoint(cfg, 1, model)
    with pytest.raises(FileNotFoundError, match="no checkpoint for epoch 7"):
        ckpt.restore_checkpoint(cfg, model, "7")
    cfg.eval.ckpt = "7"
    with pytest.raises(FileNotFoundError, match="epoch 7"):
        OryonPredictor.from_config(cfg, device="cpu")


def test_restore_params_only_spec_forms(tmp_path):
    """'<exp>', '<exp>:<epoch|last>' and a path to an entry resolve to the
    same checkpoint; the two error messages; a model of other widths raises
    ``ValueError``."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch.models.oryon import small_oryon

    src = _cfg(tmp_path, "src")
    ckpt.init_experiment(src)
    saved = _model(4)
    opt = torch.optim.SGD(saved.parameters(), lr=0.1)
    path = ckpt.save_checkpoint(src, 3, saved, opt, step=9)
    dst = _cfg(tmp_path, "dst", ["init_params_from=src:last"])
    for spec in (dst.init_params_from, "src", "src:3", path):
        fresh = _model(5)
        assert ckpt.restore_params_only(dst, fresh, spec) == path and _same(fresh, saved)
    with pytest.raises(FileNotFoundError, match="init_params_from=src:9: no checkpoint for "
                                                "epoch 9 in"):
        ckpt.restore_params_only(dst, _model(5), "src:9")
    with pytest.raises(FileNotFoundError, match="init_params_from=ghost:last: no checkpoints in"):
        ckpt.restore_params_only(dst, _model(5), "ghost:last")
    with pytest.raises(ValueError, match="param tree mismatch"):
        ckpt.restore_params_only(dst, small_oryon(), "src")
    with pytest.raises(ValueError, match="param tree mismatch"):
        ckpt.restore_checkpoint(src, small_oryon(), "last")


def test_init_experiment_keeps_the_training_config(tmp_path):
    """``config.yaml`` is written when absent and refreshed only on
    ``snapshot=True``; the three folders exist."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import config as tcfg

    cfg = _cfg(tmp_path, "run")
    ckpt.init_experiment(cfg)
    record = os.path.join(str(tmp_path), "run", "config.yaml")
    for d in (ckpt.ckpt_dir(cfg), ckpt.results_dir(cfg), ckpt.logs_dir(cfg)):
        assert os.path.isdir(d) and d.startswith(os.path.join(str(tmp_path), "run"))
    assert tcfg.load_config(record).test.n_corrs == 64
    cfg.test.n_corrs = 32                    # an evaluation override
    ckpt.init_experiment(cfg)
    assert tcfg.load_config(record).test.n_corrs == 64
    ckpt.init_experiment(cfg, snapshot=True)
    assert tcfg.load_config(record).test.n_corrs == 32


def test_entry_with_neither_file_raises(tmp_path):
    """An ``epoch=NNNN`` directory without ``state.pt`` or ``params.npz`` (a
    raw orbax checkpoint) is never skipped: it raises and names the export."""
    from oryon_tpu_torch import checkpoint as ckpt

    cfg = _cfg(tmp_path)
    ckpt.init_experiment(cfg)
    ckpt.save_checkpoint(cfg, 1, _model(0))
    raw = os.path.join(ckpt.ckpt_dir(cfg), "epoch=0002")
    os.makedirs(os.path.join(raw, "_METADATA_dir"))
    model = _model(1)
    with pytest.raises(ValueError, match=r"neither state\.pt nor params\.npz.*exported"):
        ckpt.restore_checkpoint(cfg, model, "last")
    with pytest.raises(ValueError, match="params.npz"):
        ckpt.restore_params_only(cfg, model, raw)
    assert ckpt.restore_checkpoint(cfg, model, "1")[0] == 1


def test_weights_loaded_after_a_first_call_are_served(tmp_path):
    """A model that has already run answers with the restored weights
    afterwards: nothing derived from the old weights (int8 codes, casts) may
    outlive a load.  The int8 tower is the one that quantises its weights."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch.models.clip import ClipVisionConfig, ClipVisionTower
    from oryon_tpu_torch.models.layers import random_init_

    class Towers(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vlm_visual = ClipVisionTower(ClipVisionConfig(
                image_size=56, patch_size=14, width=64, layers=2, heads=4, quant="int8",
                attn_impl="einsum"), torch.float32)

        def forward(self, x):
            return self.vlm_visual(x)

    def towers(seed):
        return random_init_(Towers(), torch.Generator().manual_seed(seed)).eval()

    cfg = _cfg(tmp_path)
    ckpt.init_experiment(cfg)
    new = towers(1)
    ckpt.save_checkpoint(cfg, 0, new)
    x = torch.rand(2, 56, 56, 3, generator=torch.Generator().manual_seed(2))
    used = towers(0)
    with torch.inference_mode():
        first = used(x)
        want = new(x)
        assert ckpt.restore_checkpoint(cfg, used, "last")[0] == 0
        got = used(x)
    assert not torch.allclose(first, want, atol=1e-3)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def pointdsc_dir(tmp_path_factory):
    """A directory with a fake published snapshot (a torch pickle with the
    reference's key names, 6 layers x 128 channels, from a seed) and, beside
    it, a ``native.npz`` of other weights."""
    from _torch_helpers import original_torch_state
    from oryon_tpu_torch.models import convert as C
    from oryon_tpu_torch.models.pointdsc import PointDSC
    from oryon_tpu_torch.pipeline import pointdsc_native_path, pointdsc_snapshot_path

    out = str(tmp_path_factory.mktemp("pointdsc"))
    states = {}
    for name, seed in (("snapshot", 21), ("native", 22)):
        port, original = original_torch_state(PointDSC(), "pointdsc", seed)
        port["sigma"] = original["sigma"] = np.ones(1, np.float32)
        states[name] = (port, original)
    snap = pointdsc_snapshot_path(out)
    os.makedirs(os.path.dirname(snap))
    torch.save({k: torch.from_numpy(v) for k, v in states["snapshot"][1].items()}, snap)
    C.save_flax_npz(pointdsc_native_path(out), C.convert_pointdsc(states["native"][1]))
    return out, {name: port for name, (port, _) in states.items()}


def _assert_weights(module, want):
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_pointdsc_snapshot_is_preferred_and_registers_like_jax(pointdsc_dir, capsys):
    """With both files present both packages load the snapshot and say so
    with the same words; the port's solver gives the JAX solver's pose on a
    seeded rigid pair with outliers (1e-3 rad, 1e-4 m, the bounds of
    tests/test_torch_geometry.py).  Without the snapshot, ``native.npz``."""
    import jax
    import jax.numpy as jnp

    from _torch_helpers import rotation_angle
    from oryon_tpu.pipeline import build_pointdsc_solver as jbuild
    from oryon_tpu_torch.pipeline import build_pointdsc_solver, pointdsc_snapshot_path

    directory, states = pointdsc_dir
    N = 64
    jpd, jvars = jbuild(directory, jax.random.PRNGKey(0), N)
    ref_line = capsys.readouterr().out.strip()
    pd = build_pointdsc_solver(directory)
    line = capsys.readouterr().out.strip()
    assert line == ref_line and line.startswith("PointDSC weights: reference snapshot")
    assert pd.cfg.num_layers == 6 and not pd.training
    _assert_weights(pd, states["snapshot"])

    rs = np.random.RandomState(23)
    src = (rs.rand(N, 3) - 0.5).astype(np.float32)
    Q, _ = np.linalg.qr(rs.randn(3, 3))
    Q *= np.sign(np.linalg.det(Q))
    tgt = (src @ Q.T + 0.1).astype(np.float32)
    tgt[:12] = rs.rand(12, 3)
    valid = np.ones(N, np.float32)
    valid[-6:] = 0.0
    ref = np.asarray(jpd.apply(jvars, jnp.array(src), jnp.array(tgt), jnp.array(valid))[0])
    with torch.inference_mode():
        got = pd(*(torch.from_numpy(a)[None] for a in (src, tgt, valid)))[0][0].numpy()
    assert rotation_angle(got[:3, :3], ref[:3, :3]) < 1e-3
    assert np.abs(got[:3, 3] - ref[:3, 3]).max() < 1e-4
    assert rotation_angle(got[:3, :3], Q) < 1e-3      # and it is the pair's transform

    snap = pointdsc_snapshot_path(directory)
    os.rename(snap, snap + ".away")
    try:
        _assert_weights(build_pointdsc_solver(directory), states["native"])
        assert "PointDSC weights: flax-native" in capsys.readouterr().out
    finally:
        os.rename(snap + ".away", snap)
