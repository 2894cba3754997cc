"""The port's towers under every attention configuration against the JAX
towers, from one bridged flax tree.

tiny_oryon widths, f32 on the CPU.  The JAX towers reach their Pallas
kernels in interpret mode; the port's wrappers run their plain versions.
Tolerance 2e-4 (f32 through two transformer blocks, the bound of
tests/test_torch_models.py) except where stated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, pallas_interpret, to_torch

TOL = dict(atol=2e-4, rtol=2e-4)
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def swin():
    from oryon_tpu.models.swin import SwinConfig, SwinGuidance

    x = np.random.RandomState(0).randn(B, 64, 64, 3).astype(np.float32)
    model = SwinGuidance(SwinConfig(), dtype=jnp.float32)
    params = flax_params(model, 0, jnp.array(x))
    return params, x


@pytest.mark.parametrize("stage_pad", [False, True])
@pytest.mark.parametrize("attn_impl", ["einsum", "pallas", "band"])
def test_swin_guidance_attn_impls(swin, attn_impl, stage_pad):
    """64^2 input: 16^2 tokens padded to 21^2 at stage 1 and 8^2 to 14^2 at
    stage 2, so pad tokens are keys of real windows and both shifted and
    unshifted blocks run.  ``pallas`` rounds the bias and shift mask to
    bf16 on both sides."""
    from oryon_tpu.models.swin import SwinConfig, SwinGuidance
    from oryon_tpu_torch.models.swin import SwinConfig as TCfg, SwinGuidance as TSwin

    params, x = swin
    kw = dict(attn_impl=attn_impl, stage_pad=stage_pad)
    with pallas_interpret():
        ref = SwinGuidance(SwinConfig(**kw), dtype=jnp.float32).apply(params, jnp.array(x))
    got = to_torch(TSwin(TCfg(**kw), dtype=torch.float32), params)(_t(x))
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


def test_swin_stage_pad_keeps_real_tokens(swin):
    """Padding a stage once and re-zeroing the pad region per block gives
    the per-block pad's real-token outputs (1e-5: same arithmetic)."""
    from oryon_tpu_torch.models.swin import SwinConfig, SwinGuidance

    params, x = swin
    a = to_torch(SwinGuidance(SwinConfig(), dtype=torch.float32), params)(_t(x))
    b = to_torch(SwinGuidance(SwinConfig(stage_pad=True), dtype=torch.float32), params)(_t(x))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.detach().numpy(), v.detach().numpy(), atol=1e-5)


def test_swin_noattn_floor(swin):
    """The ``noattn`` profiling floor against its JAX counterpart."""
    from oryon_tpu.models.swin import SwinConfig, SwinGuidance
    from oryon_tpu_torch.models.swin import SwinConfig as TCfg, SwinGuidance as TSwin

    params, x = swin
    kw = dict(attn_impl="noattn")
    ref = SwinGuidance(SwinConfig(**kw), dtype=jnp.float32).apply(params, jnp.array(x))
    got = to_torch(TSwin(TCfg(**kw), dtype=torch.float32), params)(_t(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


def test_swin_quant_int8(swin):
    """``quant="int8"`` puts every projection (qkv, proj, MLP, reduction) on
    the int8 path, as in the JAX tower.  The two towers cannot agree
    elementwise: where an activation sits on a rounding boundary, a last-bit
    f32 difference flips its int8 code, which moves that token's outputs by
    about 1e-2 and spreads through the window attention.  (``int8_dense``
    itself matches exactly on identical inputs, tests/test_torch_kernels.py.)
    So the bound is what the JAX tower does to itself: the typical element
    differs by no more than twice what a 1e-6 relative perturbation of the
    input moves it, and no element by more than the tower's quantisation
    noise (int8 against unquantised)."""
    from oryon_tpu.models.swin import SwinConfig, SwinGuidance
    from oryon_tpu_torch.models.quant import QuantDense
    from oryon_tpu_torch.models.swin import SwinConfig as TCfg, SwinGuidance as TSwin

    params, x = swin
    jtower = SwinGuidance(SwinConfig(quant="int8"), dtype=jnp.float32)
    ref = jtower.apply(params, jnp.array(x))
    nudged = jtower.apply(params, jnp.array(x * np.float32(1 + 1e-6)))
    exact = SwinGuidance(SwinConfig(), dtype=jnp.float32).apply(params, jnp.array(x))
    tower = to_torch(TSwin(TCfg(quant="int8"), dtype=torch.float32), params)
    got = tower(_t(x))
    for r, n, e, g in zip(ref, nudged, exact, got):
        r = np.asarray(r)
        diff = np.abs(g.detach().numpy() - r)
        typical = 2 * np.median(np.abs(np.asarray(n) - r)) + 1e-5
        noise = np.abs(r - np.asarray(e)).max()
        assert np.median(diff) < typical and diff.max() < noise, (
            np.median(diff), typical, diff.max(), noise)
    quantised = {n for n, m in tower.named_modules() if isinstance(m, QuantDense)}
    assert {"stage1_block0.attn.qkv", "stage1_block1.attn.proj", "stage2_block0.mlp_fc1",
            "stage2_block1.mlp_fc2", "merge1.reduction", "merge2.reduction"} <= quantised
    assert len(quantised) == 4 * 4 + 2


@pytest.fixture(scope="module")
def clip():
    from oryon_tpu.models.clip import ClipVisionConfig, ClipVisionTower

    cfg = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4)
    x = np.random.RandomState(1).rand(B, 56, 56, 3).astype(np.float32)
    model = ClipVisionTower(ClipVisionConfig(**cfg, attn_impl="einsum"), dtype=jnp.float32)
    params = flax_params(model, 2, jnp.array(x))
    return cfg, params, x


# fused_i8qk: identical int8 codes on both sides unless an f32 input differs
# in its last bit, and then one code step moves a logit by 1/127 of its
# range, so the bound is looser
@pytest.mark.parametrize("attn_impl,tol", [("einsum", 2e-4), ("auto", 2e-4),
                                           ("fused", 2e-4), ("flash", 2e-4),
                                           ("fused_i8qk", 2e-3), ("noattn", 2e-4)])
def test_clip_vision_tower_attn_impls(clip, attn_impl, tol):
    """17 tokens; ``flash`` and ``fused_i8qk`` pad to 128 in both packages
    (segment ids and absmax scales see the same rows), ``fused`` pads only
    in the JAX tower."""
    from oryon_tpu.models.clip import ClipVisionConfig, ClipVisionTower
    from oryon_tpu_torch.models.clip import ClipVisionConfig as TCfg, ClipVisionTower as TTower

    cfg, params, x = clip
    with pallas_interpret():
        ref = ClipVisionTower(ClipVisionConfig(**cfg, attn_impl=attn_impl),
                              dtype=jnp.float32).apply(params, jnp.array(x))
    got = to_torch(TTower(TCfg(**cfg, attn_impl=attn_impl), dtype=torch.float32), params)(_t(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_fused_attention_rejects_per_sample_segments():
    """The fused kernels take one key mask for the batch: a [B, L] seg with
    differing rows raises, identical rows and the 1-D form pass."""
    from oryon_tpu_torch.models.clip import MultiHeadAttention
    from oryon_tpu_torch.models.layers import random_init_

    attn = random_init_(MultiHeadAttention(32, 2, torch.float32, "fused"),
                        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1))
    seg = (torch.arange(8) < 6).to(torch.int32)
    one = attn(x, None, seg)
    two = attn(x, None, seg.expand(2, 8))
    np.testing.assert_array_equal(one.detach().numpy(), two.detach().numpy())
    with pytest.raises(ValueError, match="per-sample"):
        attn(x, None, torch.stack([seg, 1 - seg]))
    with pytest.raises(ValueError, match=r"\[L\] or \[B, L\]"):
        attn(x, None, seg.reshape(1, 1, 8))
    with pytest.raises(ValueError, match="unmasked"):
        attn(x, torch.zeros(8, 8))


@pytest.mark.parametrize("tower,attn_impl", [
    *[("clip", a) for a in ("fused", "fused_i8qk", "flash", "einsum", "auto", "noattn")],
    *[("swin", a) for a in ("einsum", "pallas", "band", "noattn")]])
def test_one_flax_tree_feeds_every_attn_impl(swin, clip, tower, attn_impl):
    """The kernels add no parameters: the bridged tree loads strictly into
    every configuration of both towers."""
    from oryon_tpu_torch.models.clip import ClipVisionConfig, ClipVisionTower
    from oryon_tpu_torch.models.convert import from_jax_params
    from oryon_tpu_torch.models.swin import SwinConfig, SwinGuidance

    if tower == "clip":
        cfg, params, _ = clip
        module = ClipVisionTower(ClipVisionConfig(**cfg, attn_impl=attn_impl))
    else:
        params = swin[0]
        module = SwinGuidance(SwinConfig(attn_impl=attn_impl, stage_pad=True, quant="int8"))
    sd = from_jax_params(params)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("module,bad", [("clip", "pallas"), ("swin", "flash")])
def test_unknown_attn_impl_raises(module, bad):
    from oryon_tpu_torch.models.clip import MultiHeadAttention
    from oryon_tpu_torch.models.swin import WindowAttention

    with pytest.raises(ValueError, match="attn_impl"):
        if module == "clip":
            MultiHeadAttention(32, 2, attn_impl=bad)
        else:
            WindowAttention(32, 2, 7, attn_impl=bad)
