"""The arithmetic of the wgmma attention kernel (K1, K1-i8 and K5 at head
dimension 64) and the wrappers' choice of kernel by shape, on the CPU.

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
exp differ.  K1-i8: the same 2e-2 (the int8 codes and the int32 sums are
identical on both sides, the rest is K1's); the codes themselves must be
equal, entry for entry.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (StubLib, pallas_interpret, quantise_model, tiled_attention_model,
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


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1i8_prepass_codes_equal_the_plain_versions(case):
    """The model of the quantising pre-pass and ``quantise_qk_plain`` give
    the same absmax and the same int8 codes, exactly: both multiply in the
    reference's order, divide 127 by the maximum and round half to even."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import quantise_qk_plain

    qkv, _, _, _ = _k1_inputs(case, "bf16")
    B, L, _ = qkv.shape
    C = HEADS * HD
    absmax, codes = quantise_qk_plain(qkv, HEADS, HD ** -0.5)
    q, k = (t.reshape(B, L, HEADS, HD).transpose(1, 2) for t in qkv.split(C, dim=-1)[:2])
    qm, km, qi, ki = quantise_model(q, k, HD ** -0.5)
    assert absmax.shape == (B, HEADS, 2) and codes.shape == (B, L, 2 * C)
    assert codes.dtype == torch.int8
    assert torch.equal(absmax[..., 0], qm[..., 0, 0]) and torch.equal(absmax[..., 1], km[..., 0, 0])
    assert torch.equal(codes[..., :C], qi.transpose(1, 2).reshape(B, L, C))
    assert torch.equal(codes[..., C:], ki.transpose(1, 2).reshape(B, L, C))
    assert int(codes.abs().max()) == 127       # the slab's maximum maps to +-127


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1i8_tile_model_matches_plain_version(case):
    """The int8 mode's arithmetic (codes from the pre-pass, int32 tile sums
    made floats by the magic constant, descale folded with log2 e into the
    mask's FMA, exp2) against ``reference_mha(qk_int8=True)``: 2e-2 at bf16,
    as for K1, since the codes and the int32 sums are the same on both
    sides."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import reference_mha

    qkv, kmask, _, _ = _k1_inputs(case, "bf16")
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5, qk_int8=True)
    ref = reference_mha(qkv, kmask, HEADS, HD ** -0.5, qk_int8=True)
    assert torch.isfinite(got.float()).all()
    assert _max_err(got.float(), ref.float()) < TOL["bf16"]


@pytest.mark.parametrize("case", ["640-577real", "640-lead-tile-masked"])
def test_k1i8_tile_model_matches_pallas_kernel(case):
    """The same against the TPU kernel's int8 branch in interpret mode (L a
    multiple of 128): 2e-2 at bf16."""
    from oryon_tpu.ops.pallas.mha_lanes import fused_mha_lanes_qkv as jax_k1

    qkv, kmask, qkv_np, kmask_np = _k1_inputs(case, "bf16")
    ref = jax_k1(jnp.asarray(qkv_np).astype(jnp.bfloat16), jnp.asarray(kmask_np), HEADS,
                 HD ** -0.5, True, True)
    got = tiled_attention_model_packed(qkv, kmask, HEADS, HD ** -0.5, qk_int8=True)
    assert _max_err(got.float(), np.asarray(ref.astype(jnp.float32))) < TOL["bf16"]


def test_k1i8_magic_constant_is_one_shift_of_the_live_logits():
    """The int8 logits through the magic-constant FMA against the direct
    form float(si) * descale + mask: equal to 1e-4 in log2 units up to one
    shift per (image, head), which a softmax does not see."""
    import math

    from _torch_helpers import MAGIC, MAGIC_BITS
    qkv, _, _, _ = _k1_inputs("65", "bf16")
    B, L, _ = qkv.shape
    C = HEADS * HD
    q, k = (t.reshape(B, L, HEADS, HD).transpose(1, 2) for t in qkv.split(C, dim=-1)[:2])
    qm, km, qi, ki = quantise_model(q, k, HD ** -0.5)
    si = torch.einsum("bhld,bhmd->bhlm", qi.int(), ki.int())
    assert int(si.abs().max()) < 2 ** 22
    mul = (qm * km) / torch.tensor(127.0 * 127.0) * torch.tensor(math.log2(math.e))
    direct = si.float() * mul
    x = (si + MAGIC_BITS).view(torch.float32)
    folded = (x.double() * mul.double() + (-MAGIC * mul.double()).float().double()).float()
    shift = (folded - direct).mean(dim=(-2, -1), keepdim=True)
    assert float((folded - direct - shift).abs().max()) < 1e-4


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


@pytest.mark.parametrize("hd,qk_int8,entry", [
    (64, False, "oryon_fused_mha_lanes_wgmma_bf16"),
    (32, False, "oryon_fused_mha_lanes_bf16"),
    (16, False, "oryon_fused_mha_lanes_bf16"),
    (128, False, "oryon_fused_mha_lanes_bf16"),
    (64, True, "oryon_fused_mha_lanes_i8qk_wgmma_bf16"),
    (32, True, "oryon_fused_mha_lanes_i8qk_bf16"),
    (16, True, "oryon_fused_mha_lanes_i8qk_bf16"),
    (128, True, "oryon_fused_mha_lanes_i8qk_bf16")])
def test_k1_wrapper_chooses_the_kernel_by_shape(hd, qk_int8, entry):
    """Head dimension 64 goes to the wgmma kernel, with bf16 logits and
    with int8 logits (the entry that also runs the quantising pre-pass);
    every other head dimension to the WMMA kernel; one launch is counted on
    the right counter."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    stub = StubLib()
    qkv = torch.zeros(1, 8, 3 * 2 * hd, dtype=torch.bfloat16)
    before = (mha_lanes.launches, mha_lanes.launches_i8)
    out = mha_lanes._launch(stub, qkv, torch.zeros(8), 2, hd ** -0.5, qk_int8, 0)
    assert out.shape == (1, 8, 2 * hd) and out.dtype == torch.bfloat16
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert mha_lanes.kernel_entry(hd, qk_int8) == entry
    after = (mha_lanes.launches, mha_lanes.launches_i8)
    assert after == (before[0] + (not qk_int8), before[1] + qk_int8)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_k1_f32_mode_chooses_the_cuda_core_kernel(hd):
    """An f32 qkv goes to a CUDA-core kernel at every head dim, counted on
    K1's counter: at L = 8 the one-block-a-head kernel at head dims 16 and
    32, the streaming kernel at 64 and 128; with int8 logits it is refused
    (bf16 only, as in JAX)."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    stub = StubLib()
    qkv = torch.zeros(1, 8, 3 * 2 * hd)
    before = mha_lanes.launches
    out = mha_lanes._launch(stub, qkv, torch.zeros(8), 2, hd ** -0.5, False, 0)
    assert out.shape == (1, 8, 2 * hd) and out.dtype == torch.float32
    entry = "oryon_fused_mha_lanes_f32" + ("_head" if hd <= 32 else "")
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert mha_lanes.launches == before + 1
    with pytest.raises(TypeError):
        mha_lanes.kernel_entry(hd, True, torch.float32)
    with pytest.raises(TypeError):
        mha_lanes.kernel_entry(hd, False, torch.float16)


@pytest.mark.parametrize("D,entry", [(64, "oryon_flash_mha_wgmma_bf16"),
                                     (16, "oryon_flash_mha_bf16"),
                                     (32, "oryon_flash_mha_bf16"),
                                     (128, "oryon_flash_mha_bf16")])
def test_k5_wrapper_chooses_the_kernel_by_shape(D, entry):
    from oryon_tpu_torch.ops.cuda import _lib, flash

    stub = StubLib()
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
    source under csrc/, and the wgmma entries reach attn_wgmma.cuh,
    match_wgmma.cuh or swin_wgmma.cuh."""
    from oryon_tpu_torch.ops.cuda import _lib

    text = {p.name: p.read_text() for p in Path(_lib.CSRC).glob("*.cu")}
    for name in _lib.SIGNATURES:
        hits = [f for f, src in text.items()
                if re.search(r'extern "C" int ' + name + r"\(", src)]
        assert len(hits) == 1, (name, hits)
    for name, src, launcher in (
            ("oryon_fused_mha_lanes_wgmma_bf16", "mha_lanes.cu", "oryon_attn_wg::launch_packed("),
            ("oryon_fused_mha_lanes_i8qk_wgmma_bf16", "mha_lanes.cu",
             "oryon_attn_wg::launch_packed_i8("),
            ("oryon_flash_mha_wgmma_bf16", "flash.cu", "oryon_attn_wg::launch_split("),
            ("oryon_masked_argmin_wgmma_bf16", "match_kernel.cu", "oryon_match_wg::launch("),
            ("oryon_packed_window_attention_wgmma_bf16", "swin_attn.cu", "wg::launch_packed("),
            ("oryon_band_window_attention_wgmma_bf16", "swin_attn.cu", "wg::launch_band(")):
        body = text[src].split(name + "(")[1].split("\n}\n")[0]
        assert launcher in body
    # the int8 entry runs the quantising pre-pass itself
    body = text["mha_lanes.cu"].split("oryon_fused_mha_lanes_i8qk_wgmma_bf16(")[1]
    assert "qk_absmax_kernel<64>" in body and "qk_quantise_kernel" in body
    header = (Path(_lib.CSRC) / "attn_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in header
    assert "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8" in header
    match = (Path(_lib.CSRC) / "match_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in match
    swin = (Path(_lib.CSRC) / "swin_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in swin
    hopper = (Path(_lib.CSRC) / "hopper.cuh").read_text()
    assert "cp.async.bulk.tensor.3d" in hopper and "cp.async.bulk.tensor.4d" in hopper


def test_every_entry_point_is_on_a_route():
    """The library declares exactly the entries that the route functions
    return over the inputs they accept: no kernel stays in it that no
    wrapper can reach.  And launch_counts() keeps one counter a kernel."""
    from oryon_tpu_torch.ops import cuda
    from oryon_tpu_torch.ops.cuda import _lib, flash, match_kernel, mha_lanes, rope, swin_attn

    routed = set()
    for hd in (16, 32, 64, 128):
        for L in (65, mha_lanes.F32_HEAD_MAX_L, mha_lanes.F32_HEAD_MAX_L + 1):
            for i8 in (False, True):
                routed.add(mha_lanes.kernel_entry(hd, i8, torch.bfloat16, L))
            routed.add(mha_lanes.kernel_entry(hd, False, torch.float32, L))
            for dtype in (torch.bfloat16, torch.float32):
                routed.add(mha_lanes.backward_entry(hd, dtype, L))
        routed.add(flash.kernel_entry(hd))
    for hd in (16, 32, 64):
        for N in (16, 49, swin_attn.TILE):
            for band in (False, True):
                routed.add(swin_attn.kernel_entry(hd, N, band))
    routed |= {match_kernel.kernel_entry(p) for p in match_kernel.PRECISIONS}
    routed |= set(rope.ENTRIES.values())
    assert routed == set(_lib.SIGNATURES)
    assert set(cuda.launch_counts()) == {"k1", "k1i8", "k1bwd", "k2", "k2fp32", "k3", "k4",
                                         "k5", "rope"}
