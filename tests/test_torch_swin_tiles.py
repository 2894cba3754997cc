"""The arithmetic of the wgmma window-attention kernel (K3 and K4 at head
dimension 32) and the wrappers' choice of kernel by shape, on the CPU.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  What can be held here is its arithmetic: a pure-PyTorch
model (``_torch_helpers.window_tile_model``: a 64-row tile, pad keys at -inf
through the bias fragments, the bias in f32 or rounded to bf16, weights
normalised and then rounded, f32 sums) against the port's plain versions and
against the JAX package's Pallas kernels in interpret mode on the same numpy
inputs.  Tolerances: 2e-2 in bf16, the kernel tolerance on the card (the
weights and the output each round to bf16 once, about one bf16 ulp of an
output in [2, 4)); 1e-5 in f32, where only the order of sums, exp2 against
exp and the reciprocal against the division differ.  The bias re-layout must
be exact.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import StubLib, pallas_interpret, window_tile_model

TOL = {"bf16": 2e-2, "f32": 1e-5}
DTYPE = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
HEADS, HD = 2, 32
C = HEADS * HD
# name -> (images, map height, map width, window side, shifted windows)
CASES = {"N49": (2, 14, 49, 7, False), "N49-shifted": (2, 14, 49, 7, True),
         "N16": (1, 8, 28, 4, False), "N16-shifted": (1, 8, 28, 4, True)}


def _inputs(name, prec):
    """(qkv_map [B, Hp, Wp, 3C], bias [nw, heads, N, N]) as numpy f32 and the
    map as a torch tensor of the precision.  nw is 14 for every case, so the
    JAX kernel can pack 1 or 7 windows."""
    from oryon_tpu_torch.models.swin import shift_attention_mask

    B, Hp, Wp, w, shifted = CASES[name]
    N, nw = w * w, (Hp // w) * (Wp // w)
    rs = np.random.RandomState(21)
    qkv = rs.randn(B, Hp, Wp, 3 * C).astype(np.float32)
    bias = np.broadcast_to(0.5 * rs.randn(1, HEADS, N, N), (nw, HEADS, N, N)).astype(np.float32)
    if shifted:
        bias = bias + shift_attention_mask(Hp, Wp, w, w // 2)[:, None]
    return qkv, np.ascontiguousarray(bias), torch.from_numpy(qkv).to(DTYPE[prec][0])


def _windows(qkv_map, w):
    from oryon_tpu_torch.models.swin import window_partition

    return tuple(t.contiguous() for t in window_partition(qkv_map, w).chunk(3, dim=-1))


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_k3_tile_model_matches_plain_version(case, prec):
    """The kernel's arithmetic with the bias rounded to bf16 against
    ``packed_window_attention_plain``, the plain version the card holds K3
    to."""
    from oryon_tpu_torch.ops.cuda.swin_attn import packed_window_attention_plain

    _, bias, qkv_map = _inputs(case, prec)
    q, k, v = _windows(qkv_map, CASES[case][3])
    got = window_tile_model(q, k, v, torch.from_numpy(bias), HEADS, HD ** -0.5, bias_bf16=True)
    ref = packed_window_attention_plain(q, k, v, torch.from_numpy(bias), HEADS, HD ** -0.5)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert _max_err(got.float(), ref.float()) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_k4_tile_model_matches_plain_version(case, prec):
    """The kernel's arithmetic with the f32 bias against
    ``band_window_attention_plain`` on the whole map."""
    from oryon_tpu_torch.models.swin import window_reverse
    from oryon_tpu_torch.ops.cuda.swin_attn import band_window_attention_plain

    _, bias, qkv_map = _inputs(case, prec)
    B, Hp, Wp, w, _ = CASES[case]
    q, k, v = _windows(qkv_map, w)
    got = window_tile_model(q, k, v, torch.from_numpy(bias), HEADS, HD ** -0.5, bias_bf16=False)
    got = window_reverse(got, w, B, Hp, Wp)
    ref = band_window_attention_plain(qkv_map, torch.from_numpy(bias), HEADS, w, HD ** -0.5)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert _max_err(got.float(), ref.float()) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("pack", [1, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_k3_tile_model_matches_pallas_kernel(case, pack, prec):
    """The same against the TPU kernel ``packed_window_attention`` in
    interpret mode, one window a program and seven: the block-diagonal
    packing adds terms that are exactly 0 after the softmax."""
    from oryon_tpu.ops.pallas.swin_attn import packed_window_attention as jax_k3

    qkv, bias, qkv_map = _inputs(case, prec)
    w = CASES[case][3]
    q, k, v = _windows(qkv_map, w)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(DTYPE[prec][1]) for t in (q, k, v))
    with pallas_interpret():
        ref = jax_k3(jq, jk, jv, jnp.asarray(bias), HEADS, pack, HD ** -0.5)
    got = window_tile_model(q, k, v, torch.from_numpy(bias), HEADS, HD ** -0.5, bias_bf16=True)
    assert _max_err(got.float(), np.asarray(ref.astype(jnp.float32))) < TOL[prec]


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_k4_tile_model_matches_pallas_kernel(case, prec):
    """The same against the TPU kernel ``band_window_attention`` in
    interpret mode, shifted and unshifted, at 49 and 16 tokens a window."""
    from oryon_tpu.ops.pallas.swin_attn import band_window_attention as jax_k4
    from oryon_tpu_torch.models.swin import window_reverse

    qkv, bias, qkv_map = _inputs(case, prec)
    B, Hp, Wp, w, _ = CASES[case]
    with pallas_interpret():
        ref = jax_k4(jnp.asarray(qkv).astype(DTYPE[prec][1]), jnp.asarray(bias), HEADS, w,
                     HD ** -0.5)
    q, k, v = _windows(qkv_map, w)
    got = window_tile_model(q, k, v, torch.from_numpy(bias), HEADS, HD ** -0.5, bias_bf16=False)
    got = window_reverse(got, w, B, Hp, Wp)
    assert _max_err(got.float(), np.asarray(ref.astype(jnp.float32))) < TOL[prec]


@pytest.mark.parametrize("N", [1, 16, 49, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_fragments_equal_their_loop_form(N, dtype):
    """``bias_fragments_plain`` (the pre-pass's plain version) against the
    layout written out as loops over (j, thread, e), exactly: thread ``tid``
    holds row 16 * warp + lane / 4 + 8 * (e >> 1), column 8 * j +
    2 * (lane % 4) + (e & 1); -inf past column N, 0 past row N; bf16 keeps
    the pairs of j together."""
    from oryon_tpu_torch.ops.cuda.swin_attn import bias_fragments_plain

    rs = np.random.RandomState(22)
    bias = rs.randn(3, 2, N, N).astype(np.float32)
    want = np.zeros((3, 2, 8, 128, 4), np.float32)
    for j in range(8):
        for tid in range(128):
            warp, lane = divmod(tid, 32)
            for e in range(4):
                row = 16 * warp + lane // 4 + 8 * (e >> 1)
                col = 8 * j + 2 * (lane % 4) + (e & 1)
                if col >= N:
                    want[:, :, j, tid, e] = -np.inf
                elif row < N:
                    want[:, :, j, tid, e] = bias[:, :, row, col]
    got = bias_fragments_plain(torch.from_numpy(bias), dtype)
    if dtype == torch.float32:
        assert got.shape == (3, 2, 8, 128, 4) and got.dtype == torch.float32
        assert torch.equal(got, torch.from_numpy(want))
    else:
        want16 = torch.from_numpy(want).to(torch.bfloat16).reshape(3, 2, 4, 2, 128, 4)
        want16 = want16.permute(0, 1, 2, 4, 3, 5).reshape(3, 2, 4, 128, 8)
        assert got.shape == (3, 2, 4, 128, 8) and got.dtype == torch.bfloat16
        assert torch.equal(got, want16)
    assert got.is_contiguous()
    # every live element of the bias appears exactly once
    assert int(torch.isfinite(got.float()).sum()) == 3 * 2 * 64 * N


def test_bias_fragments_refuse_other_types():
    from oryon_tpu_torch.ops.cuda.swin_attn import bias_fragments_plain

    with pytest.raises(TypeError, match="f32 or bf16"):
        bias_fragments_plain(torch.zeros(1, 1, 4, 4), torch.float16)


def test_pad_keys_carry_no_weight_and_pad_rows_stay_finite():
    """A window of 16 tokens in the 64-row tile: the 48 pad keys sit at -inf
    and get weights of exactly 0, so changing v's padding cannot matter, and
    the pad rows (zero q, bias 0) stay finite before they are dropped."""
    _, bias, qkv_map = _inputs("N16-shifted", "f32")
    q, k, v = _windows(qkv_map, 4)
    b = torch.from_numpy(bias)
    whole = window_tile_model(q, k, v, b, HEADS, HD ** -0.5, bias_bf16=False)
    s = torch.einsum("bnhd,bmhd->bhnm", q.reshape(-1, 16, HEADS, HD), k.reshape(-1, 16, HEADS, HD))
    ref = torch.softmax(s * HD ** -0.5 + b.repeat(q.shape[0] // b.shape[0], 1, 1, 1), dim=-1)
    ref = torch.einsum("bhnm,bmhd->bnhd", ref, v.reshape(-1, 16, HEADS, HD)).reshape(-1, 16, C)
    assert torch.isfinite(whole).all()
    assert _max_err(whole, ref) < TOL["f32"]


@pytest.mark.parametrize("hd,N,entry", [
    (32, 49, "oryon_packed_window_attention_wgmma_bf16"),
    (32, 16, "oryon_packed_window_attention_wgmma_bf16"),
    (32, 64, "oryon_packed_window_attention_wgmma_bf16"),
    (16, 49, "oryon_packed_window_attention_bf16"),
    (64, 49, "oryon_packed_window_attention_bf16"),
    (64, 64, "oryon_packed_window_attention_bf16")])
def test_k3_wrapper_chooses_the_kernel_by_shape(hd, N, entry):
    """Head dimension 32 goes to the wgmma kernel (the entry that also runs
    the bias pre-pass), 16 and 64 to the WMMA kernel; one launch is counted."""
    from oryon_tpu_torch.ops.cuda import _lib, swin_attn

    stub = StubLib()
    q = torch.zeros(4, N, 2 * hd, dtype=torch.bfloat16)
    before = (swin_attn.launches_packed, swin_attn.launches_band)
    out = swin_attn._launch_packed(stub, q, q, q, torch.zeros(2, 2, N, N), 2, hd ** -0.5, 0)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert swin_attn.kernel_entry(hd, N, band=False) == entry
    assert (swin_attn.launches_packed, swin_attn.launches_band) == (before[0] + 1, before[1])


@pytest.mark.parametrize("hd,w,entry", [
    (32, 7, "oryon_band_window_attention_wgmma_bf16"),
    (32, 4, "oryon_band_window_attention_wgmma_bf16"),
    (32, 8, "oryon_band_window_attention_wgmma_bf16"),
    (16, 7, "oryon_band_window_attention_bf16"),
    (64, 7, "oryon_band_window_attention_bf16"),
    (64, 8, "oryon_band_window_attention_bf16")])
def test_k4_wrapper_chooses_the_kernel_by_shape(hd, w, entry):
    from oryon_tpu_torch.ops.cuda import _lib, swin_attn

    stub = StubLib()
    qkv_map = torch.zeros(1, 2 * w, w, 3 * 2 * hd, dtype=torch.bfloat16)
    before = (swin_attn.launches_packed, swin_attn.launches_band)
    out = swin_attn._launch_band(stub, qkv_map, torch.zeros(2, 2, w * w, w * w), 2, w,
                                 hd ** -0.5, 0)
    assert out.shape == (1, 2 * w, w, 2 * hd) and out.dtype == torch.bfloat16
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert swin_attn.kernel_entry(hd, w * w, band=True) == entry
    assert (swin_attn.launches_packed, swin_attn.launches_band) == (before[0], before[1] + 1)


def test_no_window_kernel_for_other_shapes():
    from oryon_tpu_torch.ops.cuda import swin_attn

    for bad in (8, 48, 128):
        with pytest.raises(ValueError, match="head dim"):
            swin_attn.kernel_entry(bad, 49, band=False)
    for band in (False, True):
        with pytest.raises(ValueError, match="at most 64 tokens"):
            swin_attn.kernel_entry(32, 81, band=band)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers return their plain versions' results and
    count no launch."""
    from oryon_tpu_torch.ops.cuda import swin_attn

    _, bias, qkv_map = _inputs("N16", "bf16")
    q, k, v = _windows(qkv_map, 4)
    b = torch.from_numpy(bias)
    before = (swin_attn.launches_packed, swin_attn.launches_band)
    assert torch.equal(swin_attn.packed_window_attention(q, k, v, b, HEADS, HD ** -0.5),
                       swin_attn.packed_window_attention_plain(q, k, v, b, HEADS, HD ** -0.5))
    assert torch.equal(swin_attn.band_window_attention(qkv_map, b, HEADS, 4, HD ** -0.5),
                       swin_attn.band_window_attention_plain(qkv_map, b, HEADS, 4, HD ** -0.5))
    assert (swin_attn.launches_packed, swin_attn.launches_band) == before


def test_window_entry_points_reach_the_wgmma_kernel():
    """The two wgmma entries are defined once in swin_attn.cu, run the bias
    pre-pass and then the launcher of swin_wgmma.cuh, whose device code holds
    the two wgmma shapes and reads K4 through a 4-D tensor map."""
    from oryon_tpu_torch.ops.cuda import _lib

    src = (Path(_lib.CSRC) / "swin_attn.cu").read_text()
    for name, fragments, launcher in (
            ("oryon_packed_window_attention_wgmma_bf16",
             "launch_bias_fragments<__nv_bfloat16>(", "wg::launch_packed("),
            ("oryon_band_window_attention_wgmma_bf16",
             "launch_bias_fragments<float>(", "wg::launch_band(")):
        assert name in _lib.SIGNATURES
        assert len(re.findall(r'extern "C" int ' + name + r"\(", src)) == 1
        body = src.split(name + "(")[1].split("\n}\n")[0]
        assert fragments in body and launcher in body
        assert body.index(fragments) < body.index(launcher)
    header = (Path(_lib.CSRC) / "swin_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in header
    assert "wgmma_ss(s, q_desc, k_desc, 0)" in header            # m64n64k16, attn_wgmma.cuh
    assert "tma_load_tile4(" in header and "encode_map_nd(" in header
    assert "cp.async.bulk.tensor.4d" in (Path(_lib.CSRC) / "hopper.cuh").read_text()
