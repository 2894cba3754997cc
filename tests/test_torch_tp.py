"""Tensor parallelism of the port (``oryon_tpu_torch/parallel/tp.py``)
against the JAX package, on the CPU with gloo ranks.

* the name-drift guard: the port's sharded parameters of the full model
  (built on the meta device) and their split axes are what
  ``oryon_tpu.parallel.tp.tp_spec`` gives over ``jax.eval_shape`` of
  ``full_oryon``, mapped through the weight bridge; per-tower fractions as
  ``tests/test_tp_fullscale.py:61-69`` pins them;
* 2 model ranks (``_torch_dist.tp_suite``): the tiny model's f32 forward
  within 1e-5 of the single-device port and within the port's 2e-4 parity
  bound of JAX; the int8 Swin and CLIP towers within each JAX tower's own
  sensitivity to a 1e-6 perturbation (``test_torch_towers.py::
  test_swin_quant_int8``); a sharded train state saved unsharded and
  restored re-sharded;
* 4 ranks as data 2 x model 2 (``_torch_dist.dp_tp_suite``): the plain-SGD
  step on the mixed-validity batch against JAX's single-device step (loss
  within rel 1e-5, stricter than ``tests/_dp_tp_body.py:63``'s 1e-3; the
  update within ``TP_REL``), and with the towers trained against the
  single-device port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_helpers import default_threads, flax_params
from test_torch_parallel import _jax_sgd_step, _mixed_validity, _update_error
from test_torch_train import _models

CLIP_CFG = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4)
# the row-parallel layers sum their partial products in another order, which
# moves an SGD update past 1e-4 of its leaf's largest value (the fusion and
# decoder convolutions carry rounding noise, ROADMAP.md F7): the update is
# held to 1e-3 of it, the relative bound tests/_dp_tp_body.py:63 holds the
# DP x TP loss to
TP_REL = 1e-3


def _jax_sharded(params) -> dict:
    """{port parameter name: split dim} of JAX's tp_spec over a flax tree
    (scanned blocks unrolled, kernels [in, out] -> weights [out, in])."""
    from oryon_tpu.parallel.tp import tp_spec

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(getattr(p, "key", p)) for p in path][1:]   # drop "params"
        axes = [i for i, s in enumerate(tp_spec(path, leaf)) if s == "model"]
        if not axes:
            continue
        (axis,) = axes
        names = [keys]
        if "resblocks" in keys and keys[keys.index("resblocks") + 1] == "block":
            j = keys.index("resblocks") + 1
            names = [keys[:j] + [str(i)] + keys[j + 1:] for i in range(leaf.shape[0])]
            axis -= 1
        for k in names:
            leafname = {"kernel": "weight", "scale": "weight"}.get(k[-1], k[-1])
            dim = (1 - axis) if k[-1] == "kernel" else axis
            out[".".join(k[:-1] + [leafname])] = dim
    return out


def _port_sharded(model) -> dict:
    from oryon_tpu_torch.parallel.tp import tp_plan

    out = {}
    for name, (kind, _, _) in tp_plan(model).items():
        out[f"{name}.weight"] = 0 if kind == "column" else 1
        if kind == "column":
            out[f"{name}.bias"] = 0
    return out


def test_tp_name_drift_guard():
    """The port's TP layers and their split axes on the full model are the
    JAX package's, and the per-tower sharded fractions stay pinned."""
    from oryon_tpu.models.oryon import full_oryon as jfull
    from oryon_tpu_torch.models.oryon import full_oryon
    from oryon_tpu_torch.parallel.tp import tp_spec

    rgb = jax.ShapeDtypeStruct((2, 224, 224, 3), jnp.float32)
    ids = jax.ShapeDtypeStruct((2, 80, 77), jnp.int32)
    shapes = jax.eval_shape(jfull().init, jax.random.PRNGKey(0), rgb, rgb, ids)
    ref = _jax_sharded({"params": shapes["params"]})
    with torch.device("meta"):
        model = full_oryon(quant="int8")
    got = _port_sharded(model)
    assert got == ref
    params = dict(model.named_parameters())
    assert {n: tp_spec(n, p) for n, p in params.items() if tp_spec(n, p) is not None} == ref
    tot, shd = {}, {}
    for n, p in params.items():
        tower = n.split(".")[0]
        tot[tower] = tot.get(tower, 0) + p.numel()
        shd[tower] = shd.get(tower, 0) + p.numel() * (n in got)
        if n in got:
            assert p.shape[got[n]] % 2 == 0, n
    assert sum(shd.values()) / sum(tot.values()) > 0.85
    for tower, least in (("vlm_visual", 0.95), ("vlm_text", 0.55), ("guidance", 0.60),
                         ("fusion", 0.20)):
        assert shd[tower] / tot[tower] > least, tower


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Rank 0's results of tp_suite (2 ranks) and dp_tp_suite (4 ranks),
    started together, and the JAX references computed meanwhile."""
    from oryon_tpu.models.clip import ClipVisionConfig, ClipVisionTower
    from oryon_tpu.models.swin import SwinConfig, SwinGuidance
    from oryon_tpu_torch.models.convert import from_jax_params

    model, params, jb, _ = _models(False, td.TRAIN_BATCH)
    rs = np.random.RandomState(0)
    x_swin = rs.randn(2, 64, 64, 3).astype(np.float32)
    x_clip = rs.rand(2, 56, 56, 3).astype(np.float32)
    swin_params = flax_params(SwinGuidance(SwinConfig(), dtype=jnp.float32), 0,
                              jnp.array(x_swin))
    clip_params = flax_params(ClipVisionTower(ClipVisionConfig(**CLIP_CFG, attn_impl="einsum"),
                                              dtype=jnp.float32), 2, jnp.array(x_clip))
    valid, cv = _mixed_validity()
    a, q, ids = (np.asarray(t) for t in (jb.anchor.rgb, jb.query.rgb, jb.prompt_ids))
    sd = from_jax_params(params)
    tmp = tmp_path_factory.mktemp("tp")
    # one suite at a time: each rank runs torch's default intra-op threads
    two = td.Ranks(2, "tp_suite", dict(
        sd=sd, swin_sd=from_jax_params(swin_params), clip_sd=from_jax_params(clip_params),
        clip_cfg=CLIP_CFG, x_swin=x_swin, x_clip=x_clip, a=a, q=q, ids=ids, valid=valid,
        corr_valid=cv, exp_root=str(tmp / "exp")), tmp)
    refs = {"forward": jax.jit(model.apply)(params, jnp.array(a), jnp.array(q),
                                            jnp.array(ids))}
    for quant_name, mk, p, x in (
            ("swin", lambda quant: SwinGuidance(SwinConfig(quant=quant), dtype=jnp.float32),
             swin_params, x_swin),
            ("clip", lambda quant: ClipVisionTower(
                ClipVisionConfig(**CLIP_CFG, attn_impl="einsum", quant=quant),
                dtype=jnp.float32), clip_params, x_clip)):
        int8 = jax.jit(mk("int8").apply)
        refs[quant_name] = [int8(p, jnp.array(x)), int8(p, jnp.array(x * np.float32(1 + 1e-6))),
                            jax.jit(mk("none").apply)(p, jnp.array(x))]
    two = two.result()
    four = td.Ranks(4, "dp_tp_suite", dict(sd=sd, valid=valid, corr_valid=cv), tmp)
    refs["sgd"] = _jax_sgd_step(1)
    return dict(sd=sd, a=a, q=q, ids=ids, valid=valid, cv=cv), two, four.result(), refs


def test_tp_forward_f32_matches_single_device_and_jax(tp):
    inputs, res, _, refs = tp
    assert res["heads"] == (2, 4)     # tiny CLIP 4 heads, Swin stage 2 8 heads, over 2 ranks
    model = td.tiny_model(inputs["sd"]).eval()
    with torch.no_grad():
        single = model(*(torch.from_numpy(inputs[k]) for k in ("a", "q", "ids")))
    for got, one, ref in zip(res["forward"], single, refs["forward"]):
        np.testing.assert_allclose(got, one.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("tower", ["swin", "clip"])
def test_tp_forward_int8_within_the_towers_sensitivity(tp, tower):
    """Row-parallel int8 projections take the whole row's activation and
    weight scales and sum the int32 partials, so the sharded int8 tower is
    the unsharded one; against JAX the bound of test_swin_quant_int8."""
    _, res, _, refs = tp
    assert res["int8_rows"] == 2 * 4 + 2 * 2     # proj + mlp_fc2 / out_proj + mlp_c_proj
    got = res[tower] if tower == "swin" else [res[tower]]
    ref, nudged, exact = (r if tower == "swin" else [r] for r in refs[tower])
    for g, r, n, e in zip(got, ref, nudged, exact):
        r = np.asarray(r)
        diff = np.abs(g - r)
        typical = 2 * np.median(np.abs(np.asarray(n) - r)) + 1e-5
        noise = np.abs(r - np.asarray(e)).max()
        assert np.median(diff) < typical and diff.max() < noise, (
            np.median(diff), typical, diff.max(), noise)


def test_tp_checkpoint_is_the_unsharded_state(tp, tmp_path):
    """save_train_state of a sharded state writes the single-device state:
    its keys and shapes, and the weights of the same SGD-momentum step on
    one device (the update bound of test_torch_train); the restore
    re-shards weights and moments exactly."""
    from oryon_tpu_torch.train import create_train_state, make_train_step

    inputs, res, _, _ = tp
    assert res["restored_epoch"] == 0 and res["restored_equal"]
    saved = torch.load(f"{res['saved']}/state.pt", weights_only=True)
    model = td.tiny_model({k: torch.from_numpy(np.array(v)) for k, v in inputs["sd"].items()})
    state = create_train_state(model, lr=1e-3, optim_type="SGD", momentum=0.9,
                               weight_decay=0.0, total_steps=10)
    with default_threads():
        state, _ = make_train_step()(state, td.train_batch(inputs["valid"], inputs["cv"]))
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    assert saved["step"] == 1 and saved["model"].keys() == ref.keys()
    for k, v in ref.items():
        assert saved["model"][k].shape == v.shape, k
    before = {k: np.asarray(v) for k, v in inputs["sd"].items()}
    got = {k: v.numpy() for k, v in saved["model"].items()}
    assert _update_error(got, before, ref) <= 0
    opt = state.optimizer.state_dict()
    assert saved["optimizer"]["param_groups"] == opt["param_groups"]
    assert saved["optimizer"]["state"].keys() == opt["state"].keys()
    for i, st in opt["state"].items():
        assert saved["optimizer"]["state"][i]["momentum_buffer"].shape == \
            st["momentum_buffer"].shape


def test_dp_tp_train_step_matches_jax(tp):
    """data 2 x model 2: the global loss and the plain-SGD update of JAX's
    single-device step."""
    _, _, res, refs = tp
    metrics, after = res["frozen"]
    before, ref, jm = refs["sgd"]
    for k, v in jm.items():
        assert metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert _update_error(after, before, ref, TP_REL) <= 0


def test_dp_tp_train_step_with_trained_towers(tp):
    """With the towers trained, the gradients cross the column- and
    row-parallel layers backwards (and the Swin bias table read at each
    rank's heads): the single-device port's step."""
    from oryon_tpu_torch.train import create_train_state, make_train_step

    inputs, _, res, _ = tp
    metrics, after = res["towers"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in inputs["sd"].items()}
    model = td.tiny_model(sd, train_towers=True)
    state = create_train_state(model, **td.SGD)
    with default_threads():
        state, ref_m = make_train_step()(state, td.train_batch(inputs["valid"], inputs["cv"]))
    for k, v in ref_m.items():
        assert metrics[k] == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    before = {k: v.numpy() for k, v in sd.items()}
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    assert _update_error(after, before, ref, TP_REL) <= 0
    moved = [k for k in ref if k.startswith(("vlm_visual", "guidance"))
             and not np.array_equal(after[k], before[k])]
    assert any("relative_position_bias_table" in k for k in moved)
    assert any("attn.in_proj" in k for k in moved) and any("mlp_fc2" in k for k in moved)

