"""The arithmetic of the wgmma attention kernel (K1 and K5 at head dimension
64) and the wrappers' choice of kernel by shape, on the CPU.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  What can be held here is its arithmetic: a pure-PyTorch
model (``_torch_helpers.tiled_attention_model``: key tiles of 64, online max
and sum in log2 units, weights rounded to the input dtype before the P V
product, deferred normalisation, the -inf guard) against the port's plain
versions and against the JAX package's functions on the same numpy inputs.
Tolerances: 2e-2 in bf16, the kernel tolerance on the card (KERNEL_TOL): the
plain versions round the logits or the normalised weights to bf16 where the
kernel keeps f32 and rounds unnormalised weights, about one bf16 ulp of an
output in [2, 4); 1e-5 in f32, where only the order of sums and exp2 against
exp differ.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (pallas_interpret, tiled_attention_model,
                            tiled_attention_model_packed)

TOL = {"bf16": 2e-2, "f32": 1e-5}
DTYPE = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
HEADS, HD = 2, 64
# name -> (B, L, first padded key, a fully masked leading key tile)
K1_CASES = {"577-560real": (2, 577, 560, False), "640-577real": (1, 640, 577, False),
            "65": (2, 65, 65, False), "1": (1, 1, 1, False),
            "640-lead-tile-masked": (1, 640, 577, True)}


def _k1_inputs(name, prec):
    B, L, real, lead = K1_CASES[name]
    rs = np.random.RandomState(11)
    qkv = rs.randn(B, L, 3 * HEADS * HD).astype(np.float32)
    kmask = np.where(np.arange(L) < real, 0.0, -1e9).astype(np.float32)
    if lead:
        kmask[:64] = -1e9
    return torch.from_numpy(qkv).to(DTYPE[prec][0]), torch.from_numpy(kmask), qkv, kmask


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_tile_model_matches_plain_version(case, prec):
    """The kernel's arithmetic against ``reference_mha``, the plain version
    the card holds K1 to."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import reference_mha

    qkv, kmask, _, _ = _k1_inputs(case, prec)
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5)
    ref = reference_mha(qkv, kmask, HEADS, HD ** -0.5)
    assert torch.isfinite(got.float()).all()
    assert _max_err(got.float(), ref.float()) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_tile_model_matches_jax_reference(case, prec):
    """The same against the JAX package's ``_reference_mha`` (any L)."""
    from oryon_tpu.ops.pallas.mha_lanes import _reference_mha

    qkv, kmask, qkv_np, kmask_np = _k1_inputs(case, prec)
    C = HEADS * HD
    x = jnp.asarray(qkv_np).astype(DTYPE[prec][1])
    ref = _reference_mha(x[..., :C], x[..., C:2 * C], x[..., 2 * C:], jnp.asarray(kmask_np),
                         HEADS, HD ** -0.5)
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5)
    assert _max_err(got.float(), np.asarray(ref.astype(jnp.float32))) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", ["640-577real", "640-lead-tile-masked"])
def test_k1_tile_model_matches_pallas_kernel(case, prec):
    """The same against the TPU kernel in interpret mode (L a multiple of
    128, as that kernel needs): it too rounds the exponentials before the
    P V product and normalises afterwards."""
    from oryon_tpu.ops.pallas.mha_lanes import fused_mha_lanes_qkv as jax_k1

    qkv, kmask, qkv_np, kmask_np = _k1_inputs(case, prec)
    ref = jax_k1(jnp.asarray(qkv_np).astype(DTYPE[prec][1]), jnp.asarray(kmask_np), HEADS,
                 HD ** -0.5, True)
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5)
    assert _max_err(got.float(), np.asarray(ref.astype(jnp.float32))) < TOL[prec]


# name -> (B, L, real tokens or None = no segments, leading tile a segment of its own)
K5_CASES = {"640-577real": (2, 640, 577, False), "640-lead-tile-own-segment": (1, 640, 577, True),
            "577-unsegmented": (1, 577, None, False), "65-unsegmented": (2, 65, None, False)}


def _k5_inputs(name, prec):
    B, L, real, lead = K5_CASES[name]
    rs = np.random.RandomState(12)
    q, k, v = (rs.randn(B, HEADS, L, HD).astype(np.float32) for _ in range(3))
    seg = None
    if real is not None:
        seg = (np.arange(L) < real).astype(np.int32)
        if lead:
            seg[:64] = 2
        seg = np.tile(seg, (B, 1))
    return (q, k, v, seg), tuple(torch.from_numpy(t).to(DTYPE[prec][0]) for t in (q, k, v))


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_tile_model_matches_plain_version(case, prec):
    """The kernel's arithmetic against ``flash_mha_plain``.  Under segments
    the padding rows see nine fully masked key tiles before their first live
    key: the guard keeps them finite."""
    from oryon_tpu_torch.ops.cuda.flash import flash_mha_plain

    (_, _, _, seg), (q, k, v) = _k5_inputs(case, prec)
    seg_t = None if seg is None else torch.from_numpy(seg)
    got = tiled_attention_model(q, k, v, HD ** -0.5, seg=seg_t)
    ref = flash_mha_plain(q, k, v, HD ** -0.5, seg_t)
    assert torch.isfinite(got.float()).all()
    assert _max_err(got.float(), ref.float()) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_k5_tile_model_matches_stock_flash_kernel(prec):
    """Against the JAX package's ``flash_mha_padded`` (the stock Pallas flash
    kernel in interpret mode) at L = 640 with 577 real tokens, on the real
    rows (the caller drops the padding rows)."""
    from oryon_tpu.ops import flash as jflash

    (qn, kn, vn, seg), (q, k, v) = _k5_inputs("640-577real", prec)
    jd = DTYPE[prec][1]
    with pallas_interpret():
        ref = jflash.flash_mha_padded(jnp.asarray(qn).astype(jd), jnp.asarray(kn).astype(jd),
                                      jnp.asarray(vn).astype(jd), HD ** -0.5, jnp.asarray(seg))
    got = tiled_attention_model(q, k, v, HD ** -0.5, seg=torch.from_numpy(seg))
    assert _max_err(got.float()[:, :, :577], np.asarray(ref.astype(jnp.float32))[:, :, :577]) \
        < TOL[prec]


def test_guard_is_what_keeps_masked_leading_tiles_finite():
    """Without the guard a row whose first key tile is fully masked takes
    exp2(-inf - -inf) = NaN; with an additive -1e9 mask the max stays finite
    and no guard is needed."""
    (_, _, _, seg), (q, k, v) = _k5_inputs("640-lead-tile-own-segment", "f32")
    bad = tiled_attention_model(q, k, v, HD ** -0.5, seg=torch.from_numpy(seg), guard=False)
    assert torch.isnan(bad).any()
    qkv, kmask, _, _ = _k1_inputs("640-lead-tile-masked", "f32")
    ok = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5, guard=False)
    assert torch.isfinite(ok).all()


@pytest.mark.parametrize("tile", [64, 128])
def test_tile_size_does_not_change_the_result_beyond_rounding(tile):
    """Key tiles of 64 and 128 (the two the kernel was timed with) against
    one tile over all keys: 1e-5 in f32."""
    qkv, kmask, _, _ = _k1_inputs("577-560real", "f32")
    whole = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5, tile=577)
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5, tile=tile)
    assert _max_err(got, whole) < 1e-5


class _StubLib:
    """Stands in for the kernel library: records which C entry point a
    wrapper called and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, len(args)))
            return 0
        return entry


@pytest.mark.parametrize("hd,qk_int8,entry", [
    (64, False, "oryon_fused_mha_lanes_wgmma_bf16"),
    (32, False, "oryon_fused_mha_lanes_bf16"),
    (16, False, "oryon_fused_mha_lanes_bf16"),
    (128, False, "oryon_fused_mha_lanes_bf16"),
    (64, True, "oryon_fused_mha_lanes_i8qk_bf16"),
    (32, True, "oryon_fused_mha_lanes_i8qk_bf16")])
def test_k1_wrapper_chooses_the_kernel_by_shape(hd, qk_int8, entry):
    """Head dimension 64 with bf16 logits goes to the wgmma kernel, every
    other head dimension to the WMMA kernel, int8 logits to K1-i8 at every
    head dimension; one launch is counted on the right counter."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    stub = _StubLib()
    qkv = torch.zeros(1, 8, 3 * 2 * hd, dtype=torch.bfloat16)
    before = (mha_lanes.launches, mha_lanes.launches_i8)
    out = mha_lanes._launch(stub, qkv, torch.zeros(8), 2, hd ** -0.5, qk_int8, 0)
    assert out.shape == (1, 8, 2 * hd) and out.dtype == torch.bfloat16
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert mha_lanes.kernel_entry(hd, qk_int8) == entry
    after = (mha_lanes.launches, mha_lanes.launches_i8)
    assert after == (before[0] + (not qk_int8), before[1] + qk_int8)


@pytest.mark.parametrize("D,entry", [(64, "oryon_flash_mha_wgmma_bf16"),
                                     (16, "oryon_flash_mha_bf16"),
                                     (32, "oryon_flash_mha_bf16"),
                                     (128, "oryon_flash_mha_bf16")])
def test_k5_wrapper_chooses_the_kernel_by_shape(D, entry):
    from oryon_tpu_torch.ops.cuda import _lib, flash

    stub = _StubLib()
    q = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
    before = flash.launches
    out = flash._launch(stub, q, q, q, D ** -0.5, None, 0)
    assert out.shape == q.shape
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert flash.launches == before + 1


def test_no_kernel_for_other_head_dims():
    from oryon_tpu_torch.ops.cuda import flash, mha_lanes

    for bad in (8, 48, 96, 256):
        with pytest.raises(ValueError, match="head dim"):
            mha_lanes.kernel_entry(bad, False)
        with pytest.raises(ValueError, match="head dim"):
            flash.kernel_entry(bad)


def test_every_entry_point_is_defined_once_in_the_sources():
    """Each name the wrappers may call is an ``extern "C"`` function of one
    source under csrc/, and the wgmma entries reach attn_wgmma.cuh."""
    from oryon_tpu_torch.ops.cuda import _lib

    text = {p.name: p.read_text() for p in Path(_lib.CSRC).glob("*.cu")}
    for name in _lib.SIGNATURES:
        hits = [f for f, src in text.items()
                if re.search(r'extern "C" int ' + name + r"\(", src)]
        assert len(hits) == 1, (name, hits)
    for name, src, launcher in (("oryon_fused_mha_lanes_wgmma_bf16", "mha_lanes.cu", "launch_packed"),
                                ("oryon_flash_mha_wgmma_bf16", "flash.cu", "launch_split")):
        body = text[src].split(name + "(")[1].split("\n}\n")[0]
        assert f"oryon_attn_wg::{launcher}" in body
    header = (Path(_lib.CSRC) / "attn_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in header
    assert "cp.async.bulk.tensor.3d" in header
