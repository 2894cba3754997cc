"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# B, L, heads, head dim, first padded key, keys 0-63 masked too.  Head dim 64
# runs the wgmma kernel, 16 / 32 / 128 the WMMA kernel.
MHA_CASES = [(2, 256, 4, 16, 200, False),
             (3, 577, 16, 64, 577, False),
             (2, 130, 8, 32, 100, False),
             (1, 70, 2, 128, 64, False),
             (1, 577, 16, 64, 560, False),    # one image, ragged L, pad mask
             (2, 640, 4, 64, 640, False),     # whole tiles, nothing masked
             (2, 640, 4, 64, 577, True),      # a fully masked leading key tile
             (2, 65, 2, 64, 65, False),       # one live row in the second tile
             (1, 1, 2, 64, 1, False),
             (2, 63, 2, 64, 40, False),       # L below one tile
             (2, 640, 4, 32, 577, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd,real,lead", MHA_CASES)
def test_mha_kernel_matches_plain(cuda, B, L, H, hd, real, lead):
    """K1 vs its plain version at bf16, unit-variance inputs, pad keys
    masked at -1e9; tolerance 2e-2 (bf16 inputs and outputs, f32 vs bf16
    logits in the plain version).  Two launches on the same inputs give
    bitwise the same output."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(B, L, 3 * H * hd).astype(np.float32))
    q = q.to(cuda, torch.bfloat16)
    m = torch.where(torch.arange(L) < real, 0.0, -1e9)
    if lead:
        m[:64] = -1e9
    m = m.to(cuda)
    got = mha_lanes.fused_mha_lanes_qkv(q, m, H, hd ** -0.5)
    again = mha_lanes.fused_mha_lanes_qkv(q, m, H, hd ** -0.5)
    ref = mha_lanes.reference_mha(q, m, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_argmin_kernel_matches_plain(cuda, precision):
    """K2 vs its plain version on ragged sizes: fp32 minima within 1e-5 and
    argmins identical except at near-ties (>= 99.9%); bf16 >= 99%."""
    from oryon_tpu_torch.ops.cuda import match_kernel as mk

    rs = np.random.RandomState(1)
    P, S, N = 3, 700, 1000
    src = torch.from_numpy(_unit(rs.randn(P, S, 32)).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy(_unit(rs.randn(P, N, 32)).astype(np.float32)).to(cuda)
    bad = torch.from_numpy(rs.rand(P, N) > 0.6).to(cuda)
    md, am = mk.masked_argmin(src, tgt, bad, precision)
    pm, pa = mk.masked_argmin_plain(src, tgt, bad, precision)
    torch.cuda.synchronize()
    same = (am == pa).float().mean().item()
    if precision == "fp32":
        assert torch.allclose(md, pm, atol=1e-5)
        assert same >= 0.999
    else:
        assert same >= 0.99


def _argmin_case(rs, device, P, S, N, kind):
    src = torch.from_numpy(_unit(rs.randn(P, S, 32)).astype(np.float32))
    tgt = torch.from_numpy(_unit(rs.randn(P, N, 32)).astype(np.float32))
    bad = torch.from_numpy(rs.rand(P, N) < 0.4)
    if kind == "edges":
        # pair 0: everything excluded; pair 1: one target kept; pair 2:
        # nothing excluded; pair 3: the best target of rows 0-39 three times
        bad[0] = True
        bad[1] = True
        bad[1, N // 2] = False
        bad[2] = False
        tgt[3, 200:240] = tgt[3, 60:100]
        tgt[3, N - 40:] = tgt[3, 60:100]
        bad[3, 60:100] = bad[3, 200:240] = bad[3, N - 40:] = False
        src[3, :40] = tgt[3, 60:100]
    elif kind == "sparse":
        bad = torch.from_numpy(rs.rand(P, N) < 0.95)
    return src.to(device), tgt.to(device), bad.to(device)


# P, S, N, kind: S and N off the tiles of 128, a single tile, the edge pairs
ARGMIN_BF16_CASES = [(3, 700, 1000, "random"), (4, 333, 1001, "edges"), (2, 64, 128, "random"),
                     (1, 1, 1, "random"), (2, 130, 4097, "sparse"), (4, 128, 640, "edges")]


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,N,kind", ARGMIN_BF16_CASES)
def test_argmin_wgmma_kernel_matches_plain(cuda, P, S, N, kind):
    """K2's tensor-core kernel (bf16 mode) vs the plain version: minima
    within 1e-5, argmins identical except at near-ties (the two plain
    distances within 1e-6); all excluded gives (+inf, 0), one kept gives it,
    duplicated targets give the lowest index; the pre-pass's rows, map and
    counts equal the plain compaction's; two launches bitwise equal."""
    from oryon_tpu_torch.ops.cuda import match_kernel as mk

    src, tgt, bad = _argmin_case(np.random.RandomState(6), cuda, P, S, N, kind)
    md, am = mk.masked_argmin(src, tgt, bad, "bf16")
    md2, am2 = mk.masked_argmin(src, tgt, bad, "bf16")
    pm, pa = mk.masked_argmin_plain(src, tgt, bad, "bf16")
    torch.cuda.synchronize()
    assert torch.equal(md, md2) and torch.equal(am, am2)
    finite = torch.isfinite(pm)
    assert torch.equal(torch.isfinite(md), finite)
    assert torch.equal(md[~finite], pm[~finite]) and (am[~finite] == 0).all()
    assert (md[finite] - pm[finite]).abs().max().item() < 1e-5 if finite.any() else True
    s16, t16 = src.bfloat16().float(), tgt.bfloat16().float()
    for p, s in torch.nonzero(am != pa).tolist():
        d = 0.5 * (1.0 - t16[p] @ s16[p, s])
        assert not bad[p, am[p, s]]
        assert abs((d[am[p, s]] - d[pa[p, s]]).item()) <= 1e-6
    if kind == "edges":
        assert (am[1] == N // 2).all()
        assert torch.equal(am[3, :40].cpu(), torch.arange(60, 100, dtype=torch.int32))
    scratch = mk._bf16_scratch(src, tgt)
    mk.run_bf16_phases(src, tgt, bad, mk.COMPACT, scratch, md2, am2)
    torch.cuda.synchronize()
    r16, rmap, rcount = mk.compact_targets_plain(tgt, bad)
    assert torch.equal(scratch[2], rcount)
    for p in range(P):
        n = int(rcount[p])
        assert torch.equal(scratch[0][p, :n], r16[p, :n]) and torch.equal(scratch[1][p, :n], rmap[p, :n])


def _bf16(rs, *shape, device):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, torch.bfloat16)


# B, L, heads, head dim, first padded key, keys 0-63 masked too.  Head dim 64
# runs the int8 wgmma kernel behind the quantising pre-pass, 16 / 32 / 128
# the WMMA kernel.
MHA_I8_CASES = [(2, 256, 4, 16, 200, False),
                (1, 640, 16, 64, 577, False),
                (2, 130, 8, 32, 100, False),
                (1, 70, 2, 128, 70, False),
                (2, 640, 4, 64, 640, False),    # whole tiles, nothing masked
                (2, 640, 4, 64, 577, True),     # a fully masked leading key tile
                (3, 577, 16, 64, 560, False),   # ragged L
                (2, 65, 2, 64, 65, False),
                (1, 1, 2, 64, 1, False),
                (2, 63, 2, 64, 40, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd,real,lead", MHA_I8_CASES)
def test_mha_int8_kernel_matches_plain(cuda, B, L, H, hd, real, lead):
    """K1-i8 vs its plain version: the int8 codes and int32 sums are the
    same on both sides, so K1's tolerance holds (2e-2: bf16 exponentials,
    deferred normalisation, bf16 output).  Two launches bitwise equal; at
    head dim 64 the pre-pass alone gives the plain version's absmax and
    codes exactly."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv = _bf16(np.random.RandomState(2), B, L, 3 * H * hd, device=cuda)
    m = torch.where(torch.arange(L) < real, 0.0, -1e9)
    if lead:
        m[:64] = -1e9
    m = m.to(cuda)
    before = mha_lanes.launches_i8
    got = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, hd ** -0.5, qk_int8=True)
    again = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, hd ** -0.5, qk_int8=True)
    ref = mha_lanes.reference_mha(qkv, m, H, hd ** -0.5, qk_int8=True)
    torch.cuda.synchronize()
    assert mha_lanes.launches_i8 == before + 2
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2
    if hd == 64:
        absmax, codes = mha_lanes._i8_scratch(qkv, H)
        mha_lanes.run_i8_phases(qkv, m, H, hd ** -0.5, mha_lanes.PREPASS, absmax, codes, again)
        torch.cuda.synchronize()
        ref_absmax, ref_codes = mha_lanes.quantise_qk_plain(qkv, H, hd ** -0.5)
        assert torch.equal(absmax, ref_absmax) and torch.equal(codes, ref_codes)


# B, heads, L, head dim, real tokens (None = no segment ids), keys 0-63 a
# segment of their own.  Head dim 64 runs the wgmma kernel.
FLASH_CASES = [(2, 4, 256, 16, 200, False),
               (1, 16, 640, 64, 577, False),
               (3, 2, 130, 32, 100, False),
               (1, 2, 70, 128, None, False),
               (2, 8, 577, 64, None, False),
               (2, 4, 640, 64, None, False),   # whole tiles, no padding
               (2, 4, 640, 64, 577, True),     # a leading key tile no other row sees
               (2, 2, 65, 64, None, False),
               (1, 2, 1, 64, None, False),
               (2, 2, 63, 64, 40, False),
               (2, 4, 640, 128, 577, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,D,real,lead", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, H, L, D, real, lead):
    """K5 vs its plain version, with segment ids (``real`` tokens, the rest
    padding that attends among itself) and without (ragged L); 2e-2 at bf16.
    Two launches on the same inputs give bitwise the same output."""
    from oryon_tpu_torch.ops.cuda import flash

    rs = np.random.RandomState(3)
    q, k, v = (_bf16(rs, B, H, L, D, device=cuda) for _ in range(3))
    if real is None:
        got = flash.flash_mha(q, k, v, D ** -0.5)
        again = flash.flash_mha(q, k, v, D ** -0.5)
        ref = flash.flash_mha_plain(q, k, v, D ** -0.5)
    else:
        seg = (torch.arange(L) < real).to(torch.int32)
        if lead:
            seg[:64] = 2
        seg = seg.expand(B, L).contiguous().to(cuda)
        got = flash.flash_mha_padded(q, k, v, D ** -0.5, seg)
        again = flash.flash_mha_padded(q, k, v, D ** -0.5, seg)
        ref = flash.flash_mha_plain(q, k, v, D ** -0.5, seg)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2


def _window_case(rs, device, B, side, C, heads, w, shifted):
    from oryon_tpu_torch.models.swin import shift_attention_mask

    N, nw = w * w, (side // w) ** 2
    qkv_map = _bf16(rs, B, side, side, 3 * C, device=device)
    bias = torch.from_numpy(0.5 * rs.randn(1, heads, N, N).astype(np.float32)).expand(
        nw, heads, N, N)
    if shifted:
        bias = bias + torch.from_numpy(shift_attention_mask(side, side, w, w // 2))[:, None]
    return qkv_map, bias.contiguous().to(device)


# images, map side, C, heads, window, shifted.  Head dim 32 runs the wgmma
# kernel (one warpgroup a (window, head), persistent blocks), 16 / 64 the
# WMMA kernel.
WINDOW_CASES = [(2, 14, 64, 2, 7, True),      # hd = 32, nw = 4, shifted
                (1, 7, 128, 2, 7, False),     # hd = 64, a single window
                (3, 21, 32, 2, 7, True),      # hd = 16, nw = 9
                (1, 8, 64, 2, 4, True),       # 16-token windows
                (2, 16, 256, 8, 8, False),    # 64-token windows: no pad rows
                (1, 7, 32, 1, 7, False),      # one window, one head: a single item
                (2, 14, 128, 4, 7, True),     # fewer items than persistent blocks
                (5, 63, 96, 3, 7, True)]      # 1215 items: several rounds, 3 heads


@pytest.mark.cuda
@pytest.mark.parametrize("B,side,C,heads,w,shifted", WINDOW_CASES)
def test_packed_window_kernel_matches_plain(cuda, B, side, C, heads, w, shifted):
    """K3 vs its plain version (bias rounded to bf16 on both sides); 2e-2.
    Two launches on the same inputs give bitwise the same output."""
    from oryon_tpu_torch.models.swin import window_partition
    from oryon_tpu_torch.ops.cuda import swin_attn

    qkv_map, bias = _window_case(np.random.RandomState(4), cuda, B, side, C, heads, w, shifted)
    q, k, v = (t.contiguous() for t in window_partition(qkv_map, w).chunk(3, dim=-1))
    scale = (C // heads) ** -0.5
    got = swin_attn.packed_window_attention(q, k, v, bias, heads, scale)
    again = swin_attn.packed_window_attention(q, k, v, bias, heads, scale)
    ref = swin_attn.packed_window_attention_plain(q, k, v, bias, heads, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,side,C,heads,w,shifted", WINDOW_CASES)
def test_band_window_kernel_matches_plain(cuda, B, side, C, heads, w, shifted):
    """K4 vs its plain version on the whole map (f32 bias); 2e-2.  Two
    launches on the same inputs give bitwise the same output."""
    from oryon_tpu_torch.ops.cuda import swin_attn

    qkv_map, bias = _window_case(np.random.RandomState(5), cuda, B, side, C, heads, w, shifted)
    scale = (C // heads) ** -0.5
    got = swin_attn.band_window_attention(qkv_map, bias, heads, w, scale)
    again = swin_attn.band_window_attention(qkv_map, bias, heads, w, scale)
    ref = swin_attn.band_window_attention_plain(qkv_map, bias, heads, w, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("w", [7, 4, 8])
@pytest.mark.parametrize("band", [False, True])
def test_window_bias_prepass_matches_plain(cuda, w, band):
    """The bias pre-pass of the wgmma window kernels alone gives the plain
    version's fragments exactly (bf16 for K3, f32 for K4), and the attention
    kernel run apart on them gives the one call's output bitwise."""
    from oryon_tpu_torch.models.swin import window_partition
    from oryon_tpu_torch.ops.cuda import swin_attn

    heads, C = 2, 64
    qkv_map, bias = _window_case(np.random.RandomState(7), cuda, 2, 2 * w, C, heads, w, True)
    scale = (C // heads) ** -0.5
    dtype = torch.float32 if band else torch.bfloat16
    frag = swin_attn._frag_scratch(bias, dtype)
    if band:
        whole = swin_attn.band_window_attention(qkv_map, bias, heads, w, scale)

        def run(phases, out):
            swin_attn.run_band_phases(qkv_map, bias, heads, w, scale, phases, frag, out)
    else:
        q, k, v = (t.contiguous() for t in window_partition(qkv_map, w).chunk(3, dim=-1))
        whole = swin_attn.packed_window_attention(q, k, v, bias, heads, scale)

        def run(phases, out):
            swin_attn.run_packed_phases(q, k, v, bias, heads, scale, phases, frag, out)
    out = torch.zeros_like(whole)
    run(swin_attn.BIAS, out)
    torch.cuda.synchronize()
    assert torch.equal(frag, swin_attn.bias_fragments_plain(bias, dtype))
    run(swin_attn.ATTEND, out)
    torch.cuda.synchronize()
    assert torch.equal(out, whole)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    """On the card a wrapper launches its kernel or raises: f32 inputs, a
    CPU bias or a head dim without an instantiation are refused."""
    from oryon_tpu_torch.ops.cuda import flash, mha_lanes, swin_attn

    f32 = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        flash.flash_mha(f32, f32, f32, 1.0)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_mha(*(torch.zeros(1, 2, 64, 48, device=cuda, dtype=torch.bfloat16),) * 3, 1.0)
    m = torch.zeros(1, 7, 7, 3 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        swin_attn.band_window_attention(m, torch.zeros(1, 2, 49, 49), 2, 7, 1.0)
    with pytest.raises(TypeError):
        swin_attn.band_window_attention(m.float(), torch.zeros(1, 2, 49, 49, device=cuda), 2, 7, 1.0)
    with pytest.raises(TypeError):
        mha_lanes.fused_mha_lanes_qkv(torch.zeros(1, 64, 192, device=cuda),
                                      torch.zeros(64, device=cuda), 2, 1.0, qk_int8=True)


@pytest.mark.cuda
def test_from_config_serves_a_checkpoint_on_the_card(cuda, tmp_path, capsys):
    """A tiny model saved with the port's ``save_checkpoint`` and restored by
    ``from_config`` on the card (its own init seed differs): the weights on
    the device are the saved ones, and a pair is answered with a finite pose.
    The tiny model computes in f32 and K1 takes bf16 only, so its tower
    answers through einsum attention here."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon

    cfg = tcfg.load_config(None, [
        "model.size=tiny", "dataset.batch_size=2", "dataset.img_size=[64, 64]",
        "test.n_corrs=64", "test.solver=ransac", "test.icp_points=128", "test.icp_iters=4",
        f"exp_root={tmp_path}", "exp_name=card", "eval.ckpt=last", "use_seed=true", "seed=3",
        f"pretrained.pointdsc={tmp_path}/none"])
    ckpt.init_experiment(cfg)
    saved = random_init_(tiny_oryon(), torch.Generator().manual_seed(8))
    ckpt.save_checkpoint(cfg, 5, saved)
    pred = OryonPredictor.from_config(cfg, depth_hw=(48, 64))
    assert "loaded checkpoint epoch 5" in capsys.readouterr().out
    assert pred.device.type == "cuda"
    for k, v in pred.model.state_dict().items():
        assert v.is_cuda and torch.equal(v.cpu(), saved.state_dict()[k]), k

    def tokenize(prompt):     # tiny has 600 token ids
        ids = np.zeros((8, 16), np.int32)
        ids[:, 0], ids[:, 1], ids[:, 2] = 598, len(prompt) % 500 + 1, 599
        return ids
    pred._tokenize = tokenize
    for blk in pred.model.vlm_visual.resblocks:
        blk.attn.attn_impl = "einsum"
    rs = np.random.RandomState(9)

    def view():
        return {"rgb": (rs.rand(64, 64, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(48, 64) * 300 + 600).astype(np.float32),
                "camera": [60.0, 60.0, 32.0, 24.0]}
    res = pred.predict_pair(view(), view(), "mug")
    assert np.isfinite(np.asarray(res["pose"])).all()
