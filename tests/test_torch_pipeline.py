"""The PyTorch port's serving slice against the JAX package, end to end.

tiny_oryon widths on the CPU in f32, the same flax weights in both packages
(``from_jax_params``), PointDSC and trimmed ICP on, and the random inputs
the JAX program draws rebuilt from its keys and handed to the port.  Masks
and valid correspondences must match exactly; poses within a geodesic bound
of 1e-3 rad and 1e-4 m.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, rotation_angle, to_torch

B, IMG, DEPTH_HW, P, CAP, MAXC = 2, 64, (48, 64), 8, 1024, 64
ICP = dict(icp_refine=True, icp_points=128, icp_iters=6, icp_trim=0.6)
CAM = np.array([60.0, 0, 32.0, 0, 60.0, 24.0, 0, 0, 1], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _views(rs):
    return dict(
        rgb=(rs.rand(B, IMG, IMG, 3) * 255).astype(np.uint8),
        mask=(rs.rand(B, IMG, IMG) > 0.5).astype(np.uint8),
        depth=(rs.rand(B, *DEPTH_HW) * 300 + 600).astype(np.uint16),
        camera=np.tile(CAM, (B, 1)),
        pose=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        size=np.tile(np.array(DEPTH_HW, np.int32), (B, 1)))


def _jax_batch(a, q):
    from oryon_tpu.data.pair_batch import PairBatch, PairView

    def view(v):
        return PairView(rgb=jnp.array(v["rgb"]), mask=jnp.array(v["mask"]),
                        depth=None, orig_depth=jnp.array(v["depth"]),
                        eval_depth=None, camera=jnp.array(v["camera"]),
                        pose=jnp.array(v["pose"]), size=jnp.array(v["size"]))
    return PairBatch(anchor=view(a), query=view(q), prompt_ids=None,
                     corrs=jnp.zeros((B, MAXC, 4), jnp.int32),
                     corr_valid=jnp.zeros((B, MAXC), bool),
                     valid=np.ones(B, np.float32), rel_pose=None,
                     cls_id=np.zeros(B, np.int64), instance_id=np.zeros(B))


def _port_batch(a, q):
    from oryon_tpu_torch.data.pair_batch import PairBatch, PairView

    def view(v):
        return PairView(rgb=_t(v["rgb"]), mask=_t(v["mask"]), depth=None,
                        orig_depth=_t(v["depth"].astype(np.float32)),
                        eval_depth=None, camera=_t(v["camera"]),
                        pose=_t(v["pose"]), size=_t(v["size"]))
    return PairBatch(anchor=view(a), query=view(q), prompt_ids=None,
                     corrs=torch.zeros((B, MAXC, 4), dtype=torch.int64),
                     corr_valid=torch.zeros((B, MAXC), dtype=torch.bool),
                     valid=torch.ones(B), rel_pose=None,
                     cls_id=np.zeros(B, np.int64), instance_id=np.zeros(B))


def _noise_from_keys(key, hw):
    """The uniforms the JAX program draws from ``key`` (pipeline.py:339-340,
    matching.py:120, pipeline.py:163), as the port's Noise."""
    from oryon_tpu_torch.pipeline import Noise

    keys = jax.random.split(key, 3 * B)
    src, out, ia, iq = [], [], [], []
    for b in range(B):
        k_src, k_out = jax.random.split(keys[b])
        src.append(jax.random.uniform(k_src, (hw,)))
        out.append(jax.random.uniform(k_out, (CAP,), minval=1e-20, maxval=1.0))
        ka, kq = jax.random.split(keys[2 * B + b])
        ia.append(jax.random.uniform(ka, (hw,)))
        iq.append(jax.random.uniform(kq, (hw,)))
    return Noise(*(_t(np.stack([np.asarray(x) for x in v]))
                   for v in (src, out)), None,
                 *(_t(np.stack([np.asarray(x) for x in v])) for v in (ia, iq)))


@pytest.fixture(scope="module")
def slice_models():
    from oryon_tpu.models.oryon import tiny_oryon
    from oryon_tpu.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.models import oryon as tor, pointdsc as tpd

    model = tiny_oryon()
    rgb = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    params = flax_params(model, 0, rgb, rgb, jnp.zeros((1, P, 16), jnp.int32))
    pcfg = dict(num_layers=2, k=16)
    pd = PointDSC(PointDSCConfig(**pcfg))
    z = jnp.zeros((MAXC, 3))
    pd_vars = flax_params(pd, 1, z, z, jnp.ones(MAXC))
    tmodel = to_torch(tor.tiny_oryon(), params)
    tpd_model = to_torch(tpd.PointDSC(tpd.PointDSCConfig(**pcfg)), pd_vars)
    return model, params, pd, pd_vars, tmodel, tpd_model


def test_run_fn_matches_jax(slice_models):
    from oryon_tpu.ops.matching import MatchParams as JMatch
    from oryon_tpu.pipeline import PipelineConfig as JCfg, make_run_fn as jmake
    from oryon_tpu_torch.ops.matching import MatchParams
    from oryon_tpu_torch.pipeline import PipelineConfig, make_run_fn

    model, params, pd, pd_vars, tmodel, tpd_model = slice_models
    rs = np.random.RandomState(0)
    a, q = _views(rs), _views(rs)
    text = rs.randn(B, P, 48).astype(np.float32)
    key = jax.random.PRNGKey(11)

    jcfg = JCfg(solver="pointdsc", match=JMatch(max_corrs=MAXC), **ICP)
    ref = jax.jit(jmake(model, jcfg, (pd, pd_vars)))(params, key, _jax_batch(a, q),
                                                     jnp.array(text))
    cfg = PipelineConfig(solver="pointdsc", match=MatchParams(max_corrs=MAXC), **ICP)
    out = make_run_fn(tmodel, cfg, tpd_model)(
        _port_batch(a, q), _t(text), noise=_noise_from_keys(key, 32 * 32))

    for name in ("mask_a", "mask_q", "corr_valid", "detection_valid", "n_corrs"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    v = np.asarray(ref.corr_valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(out.corrs.numpy()[v], np.asarray(ref.corrs)[v])
    T, T_ref = out.pred_rel_pose.numpy(), np.asarray(ref.pred_rel_pose)
    assert rotation_angle(T[:, :3, :3], T_ref[:, :3, :3]).max() < 1e-3
    assert np.abs(T[:, :3, 3] - T_ref[:, :3, 3]).max() < 1e-4
    np.testing.assert_allclose(out.packed.numpy()[:, 32:], np.asarray(ref.packed)[:, 32:],
                               atol=1e-6)


def _request(rs, prompt):
    def view():
        return {"rgb": (rs.rand(IMG, IMG, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(*DEPTH_HW) * 300 + 600).astype(np.float32),
                "camera": CAM, "mask": (rs.rand(IMG, IMG) > 0.5).astype(np.uint8)}
    return {"anchor": view(), "query": view(), "prompt": prompt}


def _fake_tokenize(prompt: str) -> np.ndarray:
    ids = np.zeros((P, 16), np.int32)
    ids[:, 0], ids[:, 1], ids[:, 2] = 598, len(prompt) % 500 + 1, 599
    return ids


def test_predictor_answers_requests(slice_models):
    """The port's OryonPredictor on the CPU: 3 requests through a batch of
    2 (the tail padded), rigid finite poses, per-prompt text cache."""
    from oryon_tpu_torch.infer import OryonPredictor

    tmodel, tpd_model = slice_models[4:]
    pred = OryonPredictor(tmodel, tpd_model, device="cpu", batch_size=2,
                          img_size=(IMG, IMG), depth_hw=DEPTH_HW, solver="pointdsc",
                          n_corrs=MAXC, tokenize_fn=_fake_tokenize, **ICP)
    rs = np.random.RandomState(1)
    reqs = [_request(rs, p) for p in ("mug", "bottle", "mug")]
    res = pred.predict(reqs, return_masks=True)
    assert len(res) == 3
    for r, req in zip(res, reqs):
        T = np.asarray(r["pose"])
        assert T.shape == (4, 4) and np.isfinite(T).all()
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-4)
        np.testing.assert_allclose(T[3], [0, 0, 0, 1])
        assert isinstance(r["n_corrs"], int) and 0 <= r["n_corrs"] <= MAXC
        assert r["prompt"] == req["prompt"] and r["mask_a"].shape == (32, 32)
    assert set(pred._text_cache) == {"mug", "bottle"}


_GUARD = r"""
import sys
import numpy as np, torch
import oryon_tpu_torch
from oryon_tpu_torch.infer import OryonPredictor
from oryon_tpu_torch.models.layers import random_init_
from oryon_tpu_torch.models.oryon import tiny_oryon
g = torch.Generator().manual_seed(0)
pred = OryonPredictor(random_init_(tiny_oryon(), g), device="cpu", batch_size=1,
                      img_size=(64, 64), depth_hw=(48, 64), n_corrs=32,
                      icp_points=64, icp_iters=2)
rs = np.random.RandomState(0)
view = lambda: {"rgb": (rs.rand(64, 64, 3) * 255).astype(np.uint8),
                "depth": np.full((48, 64), 700.0, np.float32),
                "camera": "60,60,32,24"}
res = pred.predict_pair(view(), view(), "mug")
assert np.isfinite(np.asarray(res["pose"])).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "yaml", "orbax", "oryon_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    """A fresh interpreter imports oryon_tpu_torch and serves a request on
    the CPU (the port's own tokenizer and templates) without jax, flax,
    yaml, orbax or the JAX package ever entering sys.modules."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_parse_camera_forms(tmp_path):
    """Same accepted forms as the JAX engine's parse_camera."""
    import json

    from oryon_tpu.infer import parse_camera as jax_parse
    from oryon_tpu_torch.infer import parse_camera

    p = tmp_path / "cam.json"
    p.write_text(json.dumps({"fx": 500, "fy": 510, "cx": 320, "cy": 240}))
    for spec in (CAM, list(CAM), {"K": CAM.tolist()}, "60,60,32,24", str(p),
                 {"fx": 1.0, "fy": 2.0, "cx": 3.0, "cy": 4.0}):
        np.testing.assert_array_equal(parse_camera(spec), jax_parse(spec))
