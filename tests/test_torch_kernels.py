"""The PyTorch port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel in interpret mode and against the
XLA path.  The hand-written CUDA kernels themselves are checked against
the plain versions on the card by tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _mha_inputs(rng, B=2, L=256, H=4, hd=16, real=200):
    qkv = rng.randn(B, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < real, 0.0, -1e9).astype(np.float32)
    return qkv, kmask, H, hd ** -0.5


def test_mha_plain_matches_pallas_interpret(rng):
    """K1's plain version == fused_mha_lanes_qkv (Pallas, interpret mode) at
    B=2, L=256, H=4, hd=16 with 200 real keys, f32.  Tolerance 1e-5: same
    f32 math, different summation order."""
    from oryon_tpu.ops.pallas.mha_lanes import fused_mha_lanes_qkv as jax_mha
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    qkv, kmask, H, scale = _mha_inputs(rng)
    ref = np.asarray(jax_mha(jnp.array(qkv), jnp.array(kmask), H, scale, True))
    got = fused_mha_lanes_qkv(_t(qkv), _t(kmask), H, scale).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _argmin_inputs(rng, P=2, S=256, N=512, D=32):
    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    src = unit(rng.randn(P, S, D)).astype(np.float32)
    tgt = unit(rng.randn(P, N, D)).astype(np.float32)
    bad = rng.rand(P, N) > 0.6
    return src, tgt, bad


def test_argmin_plain_matches_pallas_and_streaming(rng):
    """K2's plain version at fp32 == masked_argmin_pallas (interpret mode,
    patched as in tests/test_matching.py) and == _streaming_argmin: argmins
    identical, minima within 1e-5."""
    from jax.experimental import pallas as pl
    import oryon_tpu.ops.pallas.match_kernel as mk
    from oryon_tpu.ops.matching import _streaming_argmin
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin

    src, tgt, bad = _argmin_inputs(rng)
    md, am = masked_argmin(_t(src), _t(tgt), _t(bad), "fp32")
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        for p in range(src.shape[0]):
            pm, pa = mk.masked_argmin_pallas(jnp.array(src[p]), jnp.array(tgt[p]),
                                             jnp.array(bad[p]), src_tile=128,
                                             tgt_chunk=256)
            sm, sa = _streaming_argmin(jnp.array(src[p]), jnp.array(tgt[p]),
                                       jnp.array(bad[p]), 128, "fp32")
            for ref_m, ref_a in ((pm, pa), (sm, sa)):
                np.testing.assert_array_equal(am[p].numpy(), np.asarray(ref_a))
                np.testing.assert_allclose(md[p].numpy(), np.asarray(ref_m), atol=1e-5)
    finally:
        pl.pallas_call = orig


def test_argmin_bf16_matches_streaming(rng):
    """precision="bf16" (bf16-rounded inputs, f32 sums) against the XLA
    path's bf16 mode: argmins identical except at near-ties (>= 99%),
    minima within 1e-5."""
    from oryon_tpu.ops.matching import _streaming_argmin
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin

    src, tgt, bad = _argmin_inputs(rng, P=1)
    md, am = masked_argmin(_t(src), _t(tgt), _t(bad), "bf16")
    sm, sa = _streaming_argmin(jnp.array(src[0]), jnp.array(tgt[0]),
                               jnp.array(bad[0]), 128, "bf16")
    assert (am[0].numpy() == np.asarray(sa)).mean() >= 0.99
    np.testing.assert_allclose(md[0].numpy(), np.asarray(sm), atol=1e-5)


def test_argmin_plain_never_builds_full_matrix(rng):
    """The plain version streams the targets: an all-excluded map gives
    +inf minima and argmin 0, like the XLA path."""
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin

    src, tgt, _ = _argmin_inputs(rng, P=1, S=8, N=64)
    md, am = masked_argmin(_t(src), _t(tgt), torch.ones(1, 64, dtype=torch.bool))
    assert torch.isinf(md).all() and (am == 0).all()


def test_int8_dense_matches_jax(rng):
    """int8_dense: identical quantisation and exact integer sums, so the
    outputs agree to f32 rounding (1e-6 relative)."""
    from oryon_tpu.models.quant import int8_dense as jax_int8
    from oryon_tpu_torch.models.quant import int8_dense

    x = rng.randn(3, 40, 96).astype(np.float32)
    k = (rng.randn(96, 48) * 0.1).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    ref = np.asarray(jax_int8(jnp.array(x), jnp.array(k), jnp.array(b),
                              dtype=jnp.float32))
    got = int8_dense(_t(x), _t(k.T.copy()), _t(b), dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method,ac,out", [("cubic", False, (84, 84)),
                                           ("cubic", True, (96, 96)),
                                           ("linear", True, (40, 40))])
def test_resize2d_matches_jax(rng, method, ac, out):
    """Keys cubic (a=-0.75) with clamped borders and align_corners modes;
    f32 matmuls, tolerance 1e-5."""
    from oryon_tpu.ops.resize import resize2d as jax_resize, resize_mask_nearest
    from oryon_tpu_torch.ops import resize as port

    x = rng.rand(2, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.array(x), out, method, align_corners=ac))
    np.testing.assert_allclose(port.resize2d(_t(x), out, method, ac).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    m = (rng.rand(2, 64, 64) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        port.resize_mask_nearest(_t(m), (32, 32)).numpy(),
        np.asarray(resize_mask_nearest(jnp.array(m), (32, 32))))


def test_resize2d_first_served_then_differentiated():
    """The interpolation matrices are kept between calls: one first made
    under ``torch.inference_mode`` (serving) must still enter a computation
    that autograd tracks, whatever ran first in the process."""
    from oryon_tpu_torch.ops import resize as port

    x = torch.rand(1, 7, 9, 2, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        served = port.resize2d(x, (13, 11), "cubic")       # sizes no other test uses
    x.requires_grad_(True)
    y = port.resize2d(x, (13, 11), "cubic")
    y.sum().backward()
    assert torch.equal(y.detach(), served) and x.grad.shape == x.shape


def test_top_k_matches_lax_top_k():
    """Ties (+0.0 / -0.0 / -inf) come out in jax.lax.top_k's order."""
    from oryon_tpu_torch.ops.sampling import top_k

    x = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0, -np.inf, 0.0, 2.0, -np.inf, 1.0]],
                 np.float32)
    ref_v, ref_i = jax.lax.top_k(jnp.array(x), 10)
    got_v, got_i = top_k(_t(x), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(np.signbit(got_v.numpy()), np.signbit(np.asarray(ref_v)))


def test_sampling_matches_jax_with_same_noise(rng):
    """masked_select / masked_sample fed the uniforms JAX draws from a key
    pick the same indices."""
    from oryon_tpu.ops import sampling as js
    from oryon_tpu_torch.ops import sampling as ts

    mask = (rng.rand(300) > 0.7).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for cap in (50, 128):
        idx, valid = js.masked_select(jnp.array(mask), key, cap)
        u = np.asarray(jax.random.uniform(key, (300,)))
        tidx, tvalid = ts.masked_select(_t(mask)[None], _t(u)[None], cap)
        np.testing.assert_array_equal(tidx[0].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(tvalid[0].numpy(), np.asarray(valid))
        sidx, svalid = js.masked_sample(jnp.array(mask), key, cap)
        g = np.asarray(jax.random.uniform(key, (300,), minval=1e-20, maxval=1.0))
        tsidx, tsvalid = ts.masked_sample(_t(mask)[None], _t(g)[None], cap)
        np.testing.assert_array_equal(tsidx[0].numpy(), np.asarray(sidx))
        np.testing.assert_array_equal(tsvalid[0].numpy(), np.asarray(svalid))


def test_wrappers_reject_malformed_inputs():
    """The kernel wrappers check shapes and options before any launch."""
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    with pytest.raises(ValueError):
        fused_mha_lanes_qkv(torch.zeros(2, 8, 30), torch.zeros(8), 4, 0.5)
    with pytest.raises(ValueError):
        fused_mha_lanes_qkv(torch.zeros(2, 8, 24), torch.zeros(7), 4, 0.5)
    src, tgt = torch.zeros(1, 4, 32), torch.zeros(1, 6, 32)
    with pytest.raises(ValueError):
        masked_argmin(src, tgt, torch.zeros(1, 6, dtype=torch.bool), "fp16")
    with pytest.raises(ValueError):
        masked_argmin(src, tgt, torch.zeros(1, 5, dtype=torch.bool))
