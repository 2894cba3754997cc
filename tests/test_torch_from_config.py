"""``OryonPredictor.from_config`` and the PointDSC weight loading of the port
against the JAX package, at tiny_oryon widths on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, rotation_angle, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "config.yaml")

B, IMG, DEPTH_HW, P, MAXC = 2, 64, (48, 64), 8, 64
TINY = ["model.size=tiny", f"dataset.batch_size={B}", f"dataset.img_size=[{IMG}, {IMG}]",
        f"test.n_corrs={MAXC}", "test.icp_points=128", "test.icp_iters=6"]


def _fake_tokenize(prompt: str) -> np.ndarray:
    # tiny_oryon's vocabulary has 600 ids, the real tokenizer's 49408
    ids = np.zeros((P, 16), np.int32)
    ids[:, 0], ids[:, 1], ids[:, 2] = 598, len(prompt) % 500 + 1, 599
    return ids


def _request(rs, prompt):
    def view():
        return {"rgb": (rs.rand(IMG, IMG, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(*DEPTH_HW) * 300 + 600).astype(np.float32),
                "camera": [60.0, 60.0, 32.0, 24.0]}
    return {"anchor": view(), "query": view(), "prompt": prompt}


@pytest.fixture(scope="module")
def native_pointdsc(tmp_path_factory):
    """A flax-native PointDSC ``native.npz`` (2 layers), as
    ``scripts/train_pointdsc.py`` writes it."""
    from flax.traverse_util import flatten_dict
    from oryon_tpu.models.pointdsc import PointDSC, PointDSCConfig

    z = jnp.zeros((MAXC, 3))
    variables = flax_params(PointDSC(PointDSCConfig(num_layers=2)), 1, z, z, jnp.ones(MAXC))
    out = tmp_path_factory.mktemp("pointdsc")
    np.savez(os.path.join(out, "native.npz"),
             **{"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()})
    return str(out), variables


def test_build_pointdsc_solver_loads_native_npz(native_pointdsc, capsys):
    """The module built from ``native.npz`` has the depth of the tree and
    registers like the JAX module on the same weights (1e-3 rad, 1e-4 m)."""
    from oryon_tpu.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.pipeline import (build_pointdsc_solver, pointdsc_native_path,
                                          pointdsc_weights_available)

    directory, variables = native_pointdsc
    assert pointdsc_weights_available(directory)
    assert pointdsc_native_path(directory).endswith("native.npz")
    pd = build_pointdsc_solver(directory)
    assert "native.npz" in capsys.readouterr().out
    assert pd.cfg.num_layers == 2 and not pd.training
    rs = np.random.RandomState(2)
    src = (rs.rand(MAXC, 3) - 0.5).astype(np.float32)
    Q, _ = np.linalg.qr(rs.randn(3, 3))
    Q *= np.sign(np.linalg.det(Q))
    tgt = (src @ Q.T + 0.1).astype(np.float32)
    tgt[:12] = rs.rand(12, 3)
    valid = np.ones(MAXC, np.float32)
    ref = PointDSC(PointDSCConfig(num_layers=2)).apply(
        variables, jnp.array(src), jnp.array(tgt), jnp.array(valid))[0]
    with torch.inference_mode():
        got = pd(torch.from_numpy(src)[None], torch.from_numpy(tgt)[None],
                 torch.from_numpy(valid)[None])[0][0].numpy()
    assert rotation_angle(got[:3, :3], np.asarray(ref)[:3, :3]) < 1e-3
    assert np.abs(got[:3, 3] - np.asarray(ref)[:3, 3]).max() < 1e-4


def test_build_pointdsc_solver_refuses_missing_weights(tmp_path):
    from oryon_tpu_torch.pipeline import (build_pointdsc_solver, pointdsc_snapshot_path,
                                          pointdsc_weights_available)

    assert not pointdsc_weights_available(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        build_pointdsc_solver(str(tmp_path))
    snap = pointdsc_snapshot_path(str(tmp_path))
    os.makedirs(os.path.dirname(snap))
    open(snap, "wb").close()
    assert pointdsc_weights_available(str(tmp_path))
    with pytest.raises(NotImplementedError, match="snapshot"):
        build_pointdsc_solver(str(tmp_path))


def test_from_config_answers_like_the_jax_predictor(native_pointdsc):
    """Both engines built by ``from_config`` from one tiny config (PointDSC
    from ``native.npz``, ICP on), the JAX engine's weights bridged into the
    port's, the JAX program's random draws rebuilt from its key and handed
    to the port: the same correspondences counts and poses within the
    serving slice's bounds (1e-3 rad, 1e-4 m; tests/test_torch_pipeline.py)."""
    from oryon_tpu import config as jcfg
    from oryon_tpu.infer import OryonPredictor as JPred
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.pipeline import Noise

    directory, _ = native_pointdsc
    overrides = TINY + [f"pretrained.pointdsc={directory}"]
    jpred = JPred.from_config(jcfg.load_config(YAML, overrides), depth_hw=DEPTH_HW)
    pred = OryonPredictor.from_config(tcfg.load_config(YAML, overrides),
                                      depth_hw=DEPTH_HW, device="cpu")
    assert pred.device.type == "cpu" and pred.B == B and pred.pointdsc is not None
    to_torch(pred.model, jpred.params)
    jpred._tokenize = pred._tokenize = _fake_tokenize

    # the draws of the JAX program for its first batch (engine seed 0)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(sub, 3 * B)
    hw = 32 * 32
    draws = {"src": [], "out": [], "ia": [], "iq": []}
    for b in range(B):
        k_src, k_out = jax.random.split(keys[b])
        draws["src"].append(jax.random.uniform(k_src, (hw,)))
        draws["out"].append(jax.random.uniform(k_out, (hw,), minval=1e-20, maxval=1.0))
        ka, kq = jax.random.split(keys[2 * B + b])
        draws["ia"].append(jax.random.uniform(ka, (hw,)))
        draws["iq"].append(jax.random.uniform(kq, (hw,)))
    t = {k: torch.from_numpy(np.stack([np.asarray(x) for x in v])) for k, v in draws.items()}
    noise = Noise(t["src"], t["out"], None, t["ia"], t["iq"])
    run = pred._run
    pred._run = lambda batch, text, generator=None, stage_events=None: run(
        batch, text, noise=noise)

    rs = np.random.RandomState(3)
    reqs = [_request(rs, p) for p in ("mug", "bottle")]
    ref = jpred.predict(reqs)
    got = pred.predict(reqs)
    for r, g in zip(ref, got):
        assert g["n_corrs"] == r["n_corrs"] and g["n_corrs"] >= 4
        assert g["detection_valid"] == r["detection_valid"] and g["prompt"] == r["prompt"]
        T, T_ref = np.asarray(g["pose"]), np.asarray(r["pose"])
        assert rotation_angle(T[:3, :3], T_ref[:3, :3]) < 1e-3
        assert np.abs(T[:3, 3] - T_ref[:3, 3]).max() < 1e-4


def test_from_config_passes_every_test_field_and_falls_back_to_ransac(tmp_path, capsys):
    """Without PointDSC weights the engine warns and serves with RANSAC, as
    the JAX engine does; every ``cfg.test.*`` field reaches the pipeline."""
    from oryon_tpu_torch import config as tcfg, infer

    seen = {}
    real = infer.make_run_fn

    def spy(model, cfg, pd):
        seen["cfg"], seen["pd"] = cfg, pd
        return real(model, cfg, pd)
    overrides = TINY + [f"pretrained.pointdsc={tmp_path}", "test.mask=oracle",
                        "test.dist_th=0.3", "test.mask_threshold=0.4", "test.icp_trim=0.7"]
    with pytest.MonkeyPatch().context() as mp:
        mp.setattr(infer, "make_run_fn", spy)
        pred = infer.OryonPredictor.from_config(tcfg.load_config(YAML, overrides),
                                                depth_hw=DEPTH_HW, device="cpu", batch_size=1)
    assert "WARNING: PointDSC snapshot absent" in capsys.readouterr().out
    c = seen["cfg"]
    assert seen["pd"] is None and c.solver == "ransac" and pred.B == 1
    assert (c.mask_source, c.mask_threshold, c.match.max_corrs, c.match.dist_th) == (
        "oracle", 0.4, MAXC, 0.3)
    assert (c.icp_refine, c.icp_points, c.icp_iters, c.icp_trim) == (True, 128, 6, 0.7)
    pred._tokenize = _fake_tokenize
    res = pred.predict_pair(**{k: v for k, v in _request(np.random.RandomState(4), "mug").items()})
    assert np.isfinite(np.asarray(res["pose"])).all()


def test_from_config_refuses_a_checkpoint_it_cannot_restore():
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor

    cfg = tcfg.load_config(YAML, TINY + ["eval.ckpt=exp_data/baseline"])
    with pytest.raises(NotImplementedError, match="checkpoint restore"):
        OryonPredictor.from_config(cfg, device="cpu")


def test_from_config_seeds_its_weights():
    """The same config gives the same random weights; ``generator`` overrides."""
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor

    cfg = tcfg.load_config(YAML, TINY + ["test.solver=ransac"])
    a = OryonPredictor.from_config(cfg, device="cpu")
    b = OryonPredictor.from_config(cfg, device="cpu")
    c = OryonPredictor.from_config(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    w = "fusion.layers_0.swin_block_1.attn.qkv.weight"
    sa, sb, sc = (p.model.state_dict() for p in (a, b, c))
    key = w if w in sa else next(k for k in sa if k.endswith("qkv.weight"))
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc[key])
