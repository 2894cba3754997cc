"""Plain versions of the opt-in attention kernels (K1-i8, K3, K4, K5) of the
PyTorch port against the JAX package's Pallas kernels in interpret mode.

Inputs come from a numpy seed and go through both; everything is f32 on the
CPU, where the port's wrappers run their plain versions (the CUDA kernels
are held against the same plain versions on the card, tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import pallas_interpret

from oryon_tpu.models.swin import shift_attention_mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _window_case(rs, shifted, B=2, side=14, C=64, heads=2, w=7):
    N, nw = w * w, (side // w) ** 2
    qkv_map = rs.randn(B, side, side, 3 * C).astype(np.float32)
    bias = np.broadcast_to(0.5 * rs.randn(1, heads, N, N), (nw, heads, N, N))
    if shifted:
        bias = bias + shift_attention_mask(side, side, w, w // 2)[:, None]
    return qkv_map, np.ascontiguousarray(bias, np.float32), heads, w


def _partition(m, w):
    B, H, W, C = m.shape
    return m.reshape(B, H // w, w, W // w, w, C).transpose(0, 1, 3, 2, 4, 5).reshape(
        -1, w * w, C)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("pack", [1, 2, 4])
def test_packed_window_attention_plain_matches_pallas(rng, shifted, pack):
    """K3.  The TPU kernel packs ``pack`` windows into one block-diagonal
    product; the port computes each window alone, so every pack must give
    the port's answer.  Tolerance 1e-5: f32 on both sides, the bias rounded
    to bf16 on both sides, only the summation order differs."""
    from oryon_tpu.ops.pallas.swin_attn import packed_window_attention as jax_k3
    from oryon_tpu_torch.ops.cuda.swin_attn import packed_window_attention

    qkv_map, bias, heads, w = _window_case(rng, shifted)
    q, k, v = np.split(_partition(qkv_map, w), 3, axis=-1)
    scale = (q.shape[-1] // heads) ** -0.5
    ref = jax_k3(jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias), heads,
                 pack, scale, interpret=True)
    got = packed_window_attention(_t(q), _t(k), _t(v), _t(bias), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shifted", [False, True])
def test_band_window_attention_plain_matches_pallas(rng, shifted):
    """K4, on the whole map; the bias stays f32.  Tolerance 1e-5 (f32, other
    summation order)."""
    from oryon_tpu.ops.pallas.swin_attn import band_window_attention as jax_k4
    from oryon_tpu_torch.ops.cuda.swin_attn import band_window_attention

    qkv_map, bias, heads, w = _window_case(rng, shifted)
    scale = (qkv_map.shape[-1] // 3 // heads) ** -0.5
    ref = jax_k4(jnp.array(qkv_map), jnp.array(bias), heads, w, scale, interpret=True)
    got = band_window_attention(_t(qkv_map), _t(bias), heads, w, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_band_and_packed_differ_only_by_the_bias_rounding(rng):
    """K3 rounds the bias to bf16 and K4 does not; with a bias that bf16
    holds exactly the two plain versions agree to 1e-6, and with the -100
    shift mask plus a fractional bias they do not."""
    from oryon_tpu_torch.ops.cuda.swin_attn import (band_window_attention,
                                                    packed_window_attention)

    qkv_map, bias, heads, w = _window_case(rng, True)
    scale = (qkv_map.shape[-1] // 3 // heads) ** -0.5
    B, side = qkv_map.shape[:2]

    def both(b):
        k4 = band_window_attention(_t(qkv_map), _t(b), heads, w, scale)
        q, k, v = (t.contiguous() for t in _t(_partition(qkv_map, w)).chunk(3, -1))
        k3 = packed_window_attention(q, k, v, _t(b), heads, scale)
        C = k3.shape[-1]
        k3 = k3.reshape(B, side // w, side // w, w, w, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, side, side, C)
        return (k3 - k4).abs().max().item()

    exact = _t(bias).to(torch.bfloat16).float().numpy()
    assert both(exact) < 1e-6
    assert both(bias) > 1e-4


@pytest.mark.parametrize("padded", [False, True])
def test_flash_mha_plain_matches_stock_kernel(rng, padded):
    """K5 at L = 130 against the stock Pallas flash attention: unpadded
    ``flash_mha`` (the JAX wrapper pads to 256 and masks by segment ids) and
    ``flash_mha_padded`` on inputs padded to 256 with explicit segments.
    Tolerance 2e-3, the JAX package's own bound for this kernel against
    einsum attention (tests/test_flash.py)."""
    from oryon_tpu.ops import flash as jflash
    from oryon_tpu_torch.ops.cuda import flash

    B, H, L, D = 2, 2, 130, 16
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    sm = D ** -0.5
    if padded:
        pad = lambda x: np.pad(x, ((0, 0), (0, 0), (0, 256 - L), (0, 0)))  # noqa: E731
        q, k, v = pad(q), pad(k), pad(v)
        seg = np.tile((np.arange(256) < L).astype(np.int32), (B, 1))
        with pallas_interpret():
            ref = jflash.flash_mha_padded(jnp.array(q), jnp.array(k), jnp.array(v), sm,
                                          jnp.array(seg))
        got = flash.flash_mha_padded(_t(q), _t(k), _t(v), sm, _t(seg))
        assert torch.isfinite(got).all()      # padding rows attend among themselves
        got, ref = got.numpy()[:, :, :L], np.asarray(ref)[:, :, :L]
    else:
        with pallas_interpret():
            ref = np.asarray(jflash.flash_mha(jnp.array(q), jnp.array(k), jnp.array(v), sm))
        got = flash.flash_mha(_t(q), _t(k), _t(v), sm).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)


def test_flash_segments_are_per_image(rng):
    """Segment ids are [B, L]: two images with different padding lengths
    each match unpadded attention over their own real tokens (1e-6)."""
    from oryon_tpu_torch.ops.cuda import flash

    B, H, L, D = 2, 2, 40, 16
    q, k, v = (_t(rng.randn(B, H, L, D).astype(np.float32)) for _ in range(3))
    real = (25, 33)
    seg = torch.stack([(torch.arange(L) < r).to(torch.int32) for r in real])
    got = flash.flash_mha_padded(q, k, v, 0.25, seg)
    for b, r in enumerate(real):
        ref = flash.flash_mha(q[b:b + 1, :, :r], k[b:b + 1, :, :r], v[b:b + 1, :, :r], 0.25)
        np.testing.assert_allclose(got[b:b + 1, :, :r].numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_mha_int8_plain_matches_pallas_interpret(rng, scale):
    """K1-i8: ``reference_mha(qk_int8=True)`` against the Pallas kernel's
    int8 branch at the same L (256, 56 keys masked).  Both round half to
    even, so the int8 codes and int32 logits are identical; what is left is
    the order of f32 sums and the kernel's deferred normalisation.
    Tolerance 1e-5; found: about 1e-6 at f32.  scale = 0.3 is not a power of
    two, so q * scale rounds before it is quantised."""
    from oryon_tpu.ops.pallas.mha_lanes import fused_mha_lanes_qkv as jax_k1
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    B, L, H, hd, real = 2, 256, 4, 16, 200
    qkv = rng.randn(B, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < real, 0.0, -1e9).astype(np.float32)
    ref = jax_k1(jnp.array(qkv), jnp.array(kmask), H, scale, True, True)
    got = fused_mha_lanes_qkv(_t(qkv), _t(kmask), H, scale, qk_int8=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # and the quantisation is really there: about 1% logit noise by design
    exact = fused_mha_lanes_qkv(_t(qkv), _t(kmask), H, scale)
    assert 1e-4 < (got - exact).abs().max().item() < 5e-2


def test_mha_int8_scales_see_every_row(rng):
    """The absmax is taken over the whole [L, hd] slab, masked rows too: a
    large value in a masked row changes the codes of the real rows."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import reference_mha

    B, L, H, hd, real = 1, 64, 2, 16, 48
    qkv = rng.randn(B, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < real, 0.0, -1e9).astype(np.float32)
    base = reference_mha(_t(qkv), _t(kmask), H, 0.25, qk_int8=True)
    qkv2 = qkv.copy()
    qkv2[0, real:, :H * hd] *= 50.0            # q of the masked rows only
    moved = reference_mha(_t(qkv2), _t(kmask), H, 0.25, qk_int8=True)
    assert (base[:, :real] - moved[:, :real]).abs().max().item() > 1e-3
    exact = reference_mha(_t(qkv), _t(kmask), H, 0.25)
    exact2 = reference_mha(_t(qkv2), _t(kmask), H, 0.25)
    np.testing.assert_allclose(exact[:, :real].numpy(), exact2[:, :real].numpy(), atol=1e-6)


def _bad_calls():
    from oryon_tpu_torch.ops.cuda import flash, swin_attn

    q = torch.zeros(4, 49, 64)
    bias = torch.zeros(2, 2, 49, 49)
    m = torch.zeros(1, 14, 14, 192)
    f = torch.zeros(1, 2, 8, 16)
    return {
        "k3-heads": lambda: swin_attn.packed_window_attention(q, q, q, bias, 3, 1.0),
        "k3-shape": lambda: swin_attn.packed_window_attention(q, q[:2], q, bias, 2, 1.0),
        "k3-bias": lambda: swin_attn.packed_window_attention(q, q, q, bias[:, :1], 2, 1.0),
        "k3-nw": lambda: swin_attn.packed_window_attention(
            q, q, q, torch.zeros(3, 2, 49, 49), 2, 1.0),
        "k4-window": lambda: swin_attn.band_window_attention(
            m, torch.zeros(4, 2, 25, 25), 2, 5, 1.0),
        "k4-bias": lambda: swin_attn.band_window_attention(m, bias, 2, 7, 1.0),
        "k4-rank": lambda: swin_attn.band_window_attention(m[0], bias, 2, 7, 1.0),
        "k5-shape": lambda: flash.flash_mha(f, f[:, :1], f, 1.0),
        "k5-seg": lambda: flash.flash_mha_padded(f, f, f, 1.0, torch.zeros(1, 7, dtype=torch.int32)),
    }


@pytest.mark.parametrize("case", ["k3-heads", "k3-shape", "k3-bias", "k3-nw", "k4-window",
                                  "k4-bias", "k4-rank", "k5-shape", "k5-seg"])
def test_new_wrappers_reject_malformed_inputs(case):
    """Shape errors raise before any device work, on the CPU as on the card."""
    with pytest.raises(ValueError):
        _bad_calls()[case]()
