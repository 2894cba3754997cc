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


# K1's f32 mode: the small / tiny towers' shapes, every head dim, ragged L
MHA_F32_CASES = [(2, 65, 4, 16, 65), (2, 17, 4, 16, 17), (2, 130, 8, 32, 100),
                 (1, 577, 16, 64, 560), (1, 70, 2, 128, 64), (3, 1, 2, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd,real", MHA_F32_CASES)
def test_mha_f32_kernel_matches_plain(cuda, B, L, H, hd, real):
    """K1's f32 mode (CUDA cores) vs its plain version in f32, to 1e-5;
    one launch counted a call."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    rs = np.random.RandomState(1)
    q = torch.from_numpy(rs.randn(B, L, 3 * H * hd).astype(np.float32)).to(cuda)
    m = torch.where(torch.arange(L) < real, 0.0, -1e9).to(cuda)
    before = mha_lanes.launches
    got = mha_lanes.fused_mha_lanes_qkv(q, m, H, hd ** -0.5)
    assert mha_lanes.launches == before + 1 and got.dtype == torch.float32
    ref = mha_lanes.reference_mha(q, m, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() < 1e-5


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
    scratch = mk._scratch(src, tgt)
    mk.run_phases(src, tgt, bad, mk.COMPACT, scratch, md2, am2)
    torch.cuda.synchronize()
    r16, rmap, rcount = mk.compact_targets_plain(tgt, bad)
    assert torch.equal(scratch[2], rcount)
    for p in range(P):
        n = int(rcount[p])
        assert torch.equal(scratch[0][p, :n], r16[p, :n]) and torch.equal(scratch[1][p, :n], rmap[p, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,N,kind", ARGMIN_BF16_CASES)
def test_argmin_tf32x3_kernel_matches_plain(cuda, P, S, N, kind):
    """K2's fp32 mode (the split-TF32 tensor-core kernel) vs the plain
    version: minima within 1e-5, argmins identical except at near-ties (the
    two plain distances within 1e-6); all excluded gives (+inf, 0), one kept
    gives it, duplicated targets give the lowest index; the pre-pass's hi /
    lo rows equal ``split_tf32_plain`` of the kept rows bitwise, its map and
    counts ``torch.nonzero``'s; two launches bitwise equal."""
    from oryon_tpu_torch.ops.cuda import match_kernel as mk

    src, tgt, bad = _argmin_case(np.random.RandomState(7), cuda, P, S, N, kind)
    md, am = mk.masked_argmin(src, tgt, bad, "fp32")
    md2, am2 = mk.masked_argmin(src, tgt, bad, "fp32")
    pm, pa = mk.masked_argmin_plain(src, tgt, bad, "fp32")
    torch.cuda.synchronize()
    assert torch.equal(md, md2) and torch.equal(am, am2)
    finite = torch.isfinite(pm)
    assert torch.equal(torch.isfinite(md), finite)
    assert torch.equal(md[~finite], pm[~finite]) and (am[~finite] == 0).all()
    assert (md[finite] - pm[finite]).abs().max().item() < 1e-5 if finite.any() else True
    for p, s in torch.nonzero(am != pa).tolist():
        d = 0.5 * (1.0 - tgt[p] @ src[p, s])
        assert not bad[p, am[p, s]]
        assert abs((d[am[p, s]] - d[pa[p, s]]).item()) <= 1e-6
    if kind == "edges":
        assert (am[1] == N // 2).all()
        assert torch.equal(am[3, :40].cpu(), torch.arange(60, 100, dtype=torch.int32))
    scratch = mk._scratch(src, tgt, "fp32")
    mk.run_phases(src, tgt, bad, mk.COMPACT, scratch, md2, am2, "fp32")
    torch.cuda.synchronize()
    for p in range(P):
        kept = torch.nonzero(~bad[p]).flatten()
        n = kept.numel()
        assert int(scratch[2][p]) == n
        assert torch.equal(scratch[1][p, :n], kept.to(torch.int32))
        hi, lo = mk.split_tf32_plain(tgt[p, kept])
        assert torch.equal(scratch[0][p, 0, :n], hi) and torch.equal(scratch[0][p, 1, :n], lo)


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
    """A small model saved with the port's ``save_checkpoint`` and restored
    by ``from_config`` on the card (its own init seed differs): the weights
    on the device are the saved ones, and a pair is answered with a finite
    pose.  The small model computes in f32: its tower goes through K1's f32
    mode (2 layers, so 2 launches) and matching through K2."""
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import small_oryon
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = tcfg.load_config(None, [
        "model.size=small", "dataset.batch_size=2", "dataset.img_size=[64, 64]",
        "test.n_corrs=64", "test.solver=ransac", "test.icp_points=128", "test.icp_iters=4",
        f"exp_root={tmp_path}", "exp_name=card", "eval.ckpt=last", "use_seed=true", "seed=3",
        f"pretrained.pointdsc={tmp_path}/none"])
    ckpt.init_experiment(cfg)
    saved = random_init_(small_oryon(), torch.Generator().manual_seed(8))
    ckpt.save_checkpoint(cfg, 5, saved)
    pred = OryonPredictor.from_config(cfg, depth_hw=(48, 64))
    assert "loaded checkpoint epoch 5" in capsys.readouterr().out
    assert pred.device.type == "cuda"
    for k, v in pred.model.state_dict().items():
        assert v.is_cuda and torch.equal(v.cpu(), saved.state_dict()[k]), k
    assert all(blk.attn.attn_impl == "fused" for blk in pred.model.vlm_visual.resblocks)
    rs = np.random.RandomState(9)

    def view():
        return {"rgb": (rs.rand(64, 64, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(48, 64) * 300 + 600).astype(np.float32),
                "camera": [60.0, 60.0, 32.0, 24.0]}
    reset_launch_counts()
    res = pred.predict_pair(view(), view(), "mug")
    assert np.isfinite(np.asarray(res["pose"])).all()
    counts = launch_counts()
    assert counts["k1"] == 2 and counts["k2"] == 1, counts


@pytest.mark.cuda
def test_renderer_and_bop_on_the_card_match_the_cpu(cuda):
    """The window render, MSSD, MSPD and VSD of the same poses on the card
    and on the CPU: renders equal but for a few silhouette pixels, errors
    within 1e-4 (relative), VSD errors within 5e-3, recalls equal."""
    from oryon_tpu_torch.eval import bop
    from oryon_tpu_torch.eval.renderer import pad_mesh, render_depth_window, subdivide_mesh

    h = np.array([50.0, 40.0, 30.0])
    V = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * h
    F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    V, F = subdivide_mesh(V, F, 20.0)
    rs = np.random.RandomState(3)
    K = np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]], np.float32)
    R = np.stack([np.linalg.qr(rs.randn(3, 3))[0] for _ in range(4)]).astype(np.float32)
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = np.stack([rs.uniform(-40, 40, 4), rs.uniform(-30, 30, 4), rs.uniform(500, 700, 4)],
                 1).astype(np.float32)
    origin = np.array([[140, 220]] * 4)
    syms = np.stack([np.eye(3, 4), np.diag([-1.0, -1.0, 1.0, 0.0])[:3]]).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        mesh = pad_mesh(V, F, device=dev)
        T = [torch.from_numpy(a).to(dev) for a in (R, t, np.tile(K, (4, 1, 1)), origin)]
        d = render_depth_window(mesh, T[0], T[1], T[2], T[3], (200, 200), chunk=96)
        pts = mesh.vertices
        s = bop.mssd(T[0], T[1], T[0][[1, 2, 3, 0]], T[1], pts, torch.from_numpy(syms).to(dev))
        p = bop.mspd(T[0], T[1], T[0][[1, 2, 3, 0]], T[1], T[2], pts,
                     torch.from_numpy(syms).to(dev))
        v = bop.vsd_errors(d, d[[1, 2, 3, 0]], d + 3.0, T[2], 15.0, [0.05 * i for i in range(1, 11)],
                           120.0, origin=T[3])
        out[str(dev)] = [x.cpu().numpy() for x in (d, s, p, v, bop.mssd_recall(s, 120.0),
                                                   bop.mspd_recall(p), bop.vsd_recall(v))]
    c, g = out["cpu"], out["cuda"]
    cover = (c[0] > 0) != (g[0] > 0)
    assert (c[0] > 0).sum() > 1000 and cover.sum() <= 8
    both = (c[0] > 0) & (g[0] > 0)
    assert np.median(np.abs(c[0][both] - g[0][both])) < 1e-3
    np.testing.assert_allclose(g[1], c[1], rtol=1e-4)
    np.testing.assert_allclose(g[2], c[2], rtol=1e-4)
    np.testing.assert_allclose(g[3], c[3], atol=5e-3)
    for a, b in zip(g[4:], c[4:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_run_test_torch_main_at_small_size_on_the_card(cuda, tmp_path, capsys):
    """The evaluation CLI with the small model on the card (its f32 tower
    through K1's f32 mode): a 4-pair REAL275-format tree, VSD on, RANSAC
    and ICP; the JAX CLI's lines, the CSV and the metrics JSON; K1 two
    launches a batch (2 layers), K2 one."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    import run_test_torch
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    n = chip_smoke.write_real275_tree(str(tmp_path / "nocs_c"), np.random.RandomState(4),
                                      cuda, views=2, pairs=((0, 1), (1, 0)), scale=0.6)
    reset_launch_counts()
    sw = run_test_torch.main([
        f"dataset.root={tmp_path}", "dataset.test.name=nocs_c",
        f"dataset.test.split={chip_smoke.EVAL_SPLIT}", "model.size=small",
        "dataset.batch_size=2", "test.solver=ransac", "eval.vsd_window=160",
        f"exp_root={tmp_path}", "exp_name=card"])
    counts = launch_counts()
    out = capsys.readouterr().out
    assert "registered 4 pairs" in out and "Ours &" in out and sw.n == n == 4
    assert counts["k1"] == 2 * 2 and counts["k2"] == 2, counts
    rows = open(sw.csv).read().splitlines()
    assert len(rows) == 4 and all(len(r.split(",")) == 5 for r in rows)
    saved = json.load(open(sw.json))
    assert len(saved["VSD"]) == 4 and all(np.isfinite(saved["AR"]))


# K1's backward: B, L, heads, head dim, first padded key, keys 0-63 masked
# too, dtype.  bf16 runs the tensor-core kernels (wgmma at head dim 64,
# mma.sync at 16 / 32 / 128), f32 the CUDA-core ones.
K1_BWD_CASES = [(2, 130, 4, 64, 120, False, torch.bfloat16),
                (2, 577, 8, 64, 577, False, torch.bfloat16),   # the tower's L
                (2, 640, 4, 64, 577, True, torch.bfloat16),    # a masked leading tile
                (2, 64, 4, 64, 64, False, torch.bfloat16),     # exactly one tile
                (16, 640, 16, 64, 577, False, torch.bfloat16),  # the padded tower
                (2, 100, 4, 16, 90, False, torch.bfloat16),
                (2, 77, 4, 32, 70, False, torch.bfloat16),
                (1, 70, 2, 128, 64, False, torch.bfloat16),
                (2, 1, 2, 64, 1, False, torch.bfloat16),
                (2, 65, 4, 16, 65, False, torch.float32),      # the small tower
                (2, 17, 4, 16, 17, False, torch.float32),      # the tiny tower
                (2, 130, 4, 32, 100, False, torch.float32),
                (1, 577, 4, 64, 560, False, torch.float32),
                (1, 70, 2, 128, 64, False, torch.float32)]


def _k1_bwd_inputs(cuda, B, L, H, hd, real, lead, dtype):
    rs = np.random.RandomState(4)
    qkv = torch.from_numpy(rs.randn(B, L, 3 * H * hd).astype(np.float32)).to(cuda, dtype)
    m = torch.where(torch.arange(L) < real, 0.0, -1e9)
    if lead:
        m[:64] = -1e9
    dout = torch.from_numpy(rs.randn(B, L, H * hd).astype(np.float32)).to(cuda, dtype)
    return qkv, m.to(cuda), dout


def _assert_bwd_close(got, ref, dtype, what):
    """K1's backward tolerance: bf16 max abs error within 2e-2 of the largest
    |plain| value and cosine >= 0.9999 (both round S, P, dP and dS * scale to
    bf16, but sum in other orders, so a value near a rounding tie lands one
    ulp away); f32 within 1e-5 of the largest |plain| value (at least 1)."""
    g, r = got.float().flatten(), ref.float().flatten()
    assert torch.isfinite(g).all(), what
    err, top = (g - r).abs().max().item(), r.abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * max(1.0, top), (what, err, top)
    else:
        cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item() if top > 0 else 1.0
        assert err <= 2e-2 * top and cos >= 0.9999, (what, err, top, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd,real,lead,dtype", K1_BWD_CASES)
def test_k1_backward_kernel_matches_plain(cuda, B, L, H, hd, real, lead, dtype):
    """K1's backward kernel against its plain version (autograd through
    ``reference_mha``): d q, d k, d v and d kmask apart, every head dim and
    both dtypes, ragged L and masked keys; one launch counted a call, two
    calls bitwise equal."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv, m, dout = _k1_bwd_inputs(cuda, B, L, H, hd, real, lead, dtype)
    scale = hd ** -0.5
    before = mha_lanes.launches_bwd
    dqkv, dm = mha_lanes._backward(qkv, m, dout, H, scale, True)
    assert mha_lanes.launches_bwd == before + 1 and dqkv.dtype == dtype
    ref, ref_m = mha_lanes.reference_mha_backward(qkv, m, dout, H, scale, True)
    for i, name in enumerate(("d q", "d k", "d v")):
        part = slice(i * H * hd, (i + 1) * H * hd)
        _assert_bwd_close(dqkv[..., part], ref[..., part], dtype, name)
    _assert_bwd_close(dm, ref_m, dtype, "d kmask")
    again, again_m = mha_lanes._backward(qkv, m, dout, H, scale, True)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, again) and torch.equal(dm, again_m)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,real,lead", [(2, 130, 4, 120, False), (2, 577, 8, 577, False),
                                             (2, 640, 4, 577, True), (2, 1, 2, 1, False),
                                             (2, 64, 4, 64, False), (1, 700, 2, 650, False)])
def test_k1_backward_wgmma_matches_mma_sync_body(cuda, B, L, H, real, lead):
    """At head dim 64 the wgmma body (the route) against the mma.sync body on
    the same inputs, within the backward's tolerance of each other and both
    of the plain version, d qkv and d kmask; the wgmma body twice bitwise
    equal; neither timed-only call counts a launch.  L = 700 is past the
    640 the tower pads to."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv, m, dout = _k1_bwd_inputs(cuda, B, L, H, 64, real, lead, torch.bfloat16)
    before = mha_lanes.launches_bwd
    got = [mha_lanes.run_backward_entry(entry, qkv, m, dout, H, 0.125, True)
           for entry in (mha_lanes.BWD_WGMMA, "oryon_mha_lanes_bwd_bf16", mha_lanes.BWD_WGMMA)]
    ref = mha_lanes.reference_mha_backward(qkv, m, dout, H, 0.125, True)
    torch.cuda.synchronize()
    assert mha_lanes.launches_bwd == before
    for i, name in enumerate(("d qkv", "d kmask")):
        _assert_bwd_close(got[0][i], got[1][i], torch.bfloat16, f"wgmma vs mma.sync {name}")
        _assert_bwd_close(got[0][i], ref[i], torch.bfloat16, f"wgmma {name}")
        _assert_bwd_close(got[1][i], ref[i], torch.bfloat16, f"mma.sync {name}")
        assert torch.equal(got[0][i], got[2][i])


@pytest.mark.cuda
def test_k1_gradient_on_the_card(cuda):
    """K1 under autograd on the card: the forward launches K1 once and the
    backward K1's backward kernel once (no autograd through the plain
    version); d qkv and d kmask within the kernel's tolerance of autograd
    through the plain ``reference_mha`` (bf16: 2e-2 of the largest value,
    cosine >= 0.9999), the output within the kernel's 2e-2; with
    ``qk_int8`` the gradient is bitwise the same (straight-through)."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    rs = np.random.RandomState(4)
    B, L, H, hd = 2, 130, 4, 64
    qkv = torch.from_numpy(rs.randn(B, L, 3 * H * hd).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_()
    m = torch.where(torch.arange(L) < 120, 0.0, -1e9).to(cuda).requires_grad_()
    dout = torch.from_numpy(rs.randn(B, L, H * hd).astype(np.float32)).to(cuda, torch.bfloat16)
    before = (mha_lanes.launches, mha_lanes.launches_bwd)
    out = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, hd ** -0.5)
    dq, dm = torch.autograd.grad(out, (qkv, m), dout)
    assert (mha_lanes.launches, mha_lanes.launches_bwd) == (before[0] + 1, before[1] + 1)
    ref = mha_lanes.reference_mha(qkv, m, H, hd ** -0.5)
    dq_ref, dm_ref = torch.autograd.grad(ref, (qkv, m), dout)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    _assert_bwd_close(dq, dq_ref, torch.bfloat16, "d qkv")
    _assert_bwd_close(dm, dm_ref, torch.bfloat16, "d kmask")
    out8 = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, hd ** -0.5, qk_int8=True)
    dq8, dm8 = torch.autograd.grad(out8, (qkv, m), dout)
    torch.cuda.synchronize()
    assert torch.equal(dq8, dq) and torch.equal(dm8, dm)


@pytest.mark.cuda
def test_k1_backward_refuses_what_it_does_not_take(cuda):
    """On the card K1's backward launches its kernel or raises: an fp16 qkv,
    a dout of another dtype, a head dim without a kernel or a CPU kmask."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    m = torch.zeros(8, device=cuda)
    dout = torch.zeros(1, 8, 2 * 64, device=cuda, dtype=torch.bfloat16)
    before = mha_lanes.launches_bwd
    with pytest.raises(TypeError):
        mha_lanes._backward(qkv.half(), m, dout.half(), 2, 1.0, False)
    with pytest.raises(TypeError):
        mha_lanes._backward(qkv, m, dout.float(), 2, 1.0, False)
    with pytest.raises(ValueError, match="head dim"):
        mha_lanes._backward(torch.zeros(1, 8, 3 * 2 * 48, device=cuda, dtype=torch.bfloat16),
                            m, torch.zeros(1, 8, 2 * 48, device=cuda, dtype=torch.bfloat16),
                            2, 1.0, False)
    with pytest.raises(ValueError, match="one CUDA device"):
        mha_lanes._backward(qkv, m.cpu(), dout, 2, 1.0, False)
    assert mha_lanes.launches_bwd == before


@pytest.mark.cuda
@pytest.mark.parametrize("train_towers", [False, True])
def test_tiny_train_step_on_the_card(cuda, train_towers):
    """One train step of the tiny model (f32 towers: K1's f32 mode) on the
    card against the same step on the CPU: K1 launches 2 a step (+ 2
    recomputed and K1's backward 2 under ``train_towers``), the losses within
    1e-4 relative, the fusion weights' SGD update (linear in the gradient)
    within 1e-4 of its size; TF32 off, as the f32 parity needs."""
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.infer import full_precision_matmuls
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from oryon_tpu_torch.train import create_train_state, make_train_step

    kw = dict(seed=0, batch=2, img_hw=(28, 28), n_corrs=32, n_prompts=8, context_len=16,
              vocab=600)
    full_precision_matmuls()
    out = {}
    for dev in ("cpu", cuda):
        model = random_init_(tiny_oryon(train_towers=train_towers),
                             torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, lr=0.1, total_steps=3, optim_type="SGD")
        reset_launch_counts()
        _, m = make_train_step()(state, synthetic_pair_batch(**kw, device=dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            counts = launch_counts()
            assert counts["k1"] == (4 if train_towers else 2)
            assert counts["k1bwd"] == (2 if train_towers else 0)
        out[str(dev)] = (float(m["loss/total"]),
                         model.fusion.conv1.weight.detach().cpu().clone())
    (l_cpu, w_cpu), (l_gpu, w_gpu) = out["cpu"], out[str(cuda)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-4)
    w0 = random_init_(tiny_oryon(), torch.Generator().manual_seed(0)).fusion.conv1.weight
    step = (w_cpu - w0.detach()).abs().max().item()
    assert (w_gpu - w_cpu).abs().max().item() <= 1e-4 * step + 1e-7


# K1's f32 one-block-a-head kernels: B, L, heads, head dim.  The small and tiny
# towers' path shapes, one key, the longest L a block holds, one more (the
# route's streaming and two-kernel bodies), head dim 32.
K1_F32_HEAD_CASES = [(4, 65, 4, 16), (16, 65, 4, 16), (64, 65, 4, 16), (16, 17, 4, 16),
                     (2, 1, 4, 16), (2, 128, 4, 16), (2, 129, 4, 16), (3, 128, 2, 32),
                     (1, 100, 1, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd", K1_F32_HEAD_CASES)
def test_k1_f32_head_kernels_match_plain_and_old_bodies(cuda, B, L, H, hd):
    """K1's f32 forward and backward on the route (the one-block-a-head
    kernels where L <= 128) against their plain versions and against the
    bodies they replaced (the streaming forward, the two-kernel backward):
    forward within 1e-5, d q, d k, d v and d kmask within 1e-5 of the
    largest value (at least 1); two launches bitwise equal; the backward's
    counter back at 0."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv, m, dout = _k1_bwd_inputs(cuda, B, L, H, hd, L - L // 5, False, torch.float32)
    scale = hd ** -0.5
    got = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, scale)
    again = mha_lanes.fused_mha_lanes_qkv(qkv, m, H, scale)
    old = mha_lanes.run_entry("oryon_fused_mha_lanes_f32", qkv, m, H, scale)
    ref = mha_lanes.reference_mha(qkv, m, H, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got - ref).abs().max().item() < 1e-5
    assert (got - old).abs().max().item() < 1e-5
    dq, dm = mha_lanes._backward(qkv, m, dout, H, scale, True)
    dq2, dm2 = mha_lanes._backward(qkv, m, dout, H, scale, True)
    old_q, old_m = mha_lanes.run_backward_entry("oryon_mha_lanes_bwd_f32", qkv, m, dout, H,
                                                scale, True)
    ref_q, ref_m = mha_lanes.reference_mha_backward(qkv, m, dout, H, scale, True)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dm, dm2)
    for i, name in enumerate(("d q", "d k", "d v")):
        part = slice(i * H * hd, (i + 1) * H * hd)
        _assert_bwd_close(dq[..., part], ref_q[..., part], torch.float32, name)
        _assert_bwd_close(dq[..., part], old_q[..., part], torch.float32, f"{name} vs old")
    _assert_bwd_close(dm, ref_m, torch.float32, "d kmask")
    _assert_bwd_close(dm, old_m, torch.float32, "d kmask vs old")
    assert int(mha_lanes.head_counter(cuda)) == 0


@pytest.mark.cuda
def test_k1_f32_head_backward_leaves_its_counter_at_zero(cuda):
    """The one-block-a-head backward's device counter is 0 after one launch
    and after many in a row on one stream, with and without d kmask; every
    launch's d kmask bitwise the same; one launch counted a call."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    qkv, m, dout = _k1_bwd_inputs(cuda, 64, 65, 4, 16, 60, False, torch.float32)
    before = mha_lanes.launches_bwd
    first = mha_lanes._backward(qkv, m, dout, 4, 0.25, True)
    torch.cuda.synchronize()
    assert int(mha_lanes.head_counter(cuda)) == 0
    runs = [mha_lanes._backward(qkv, m, dout, 4, 0.25, w) for w in [True] * 40 + [False] * 3]
    torch.cuda.synchronize()
    assert int(mha_lanes.head_counter(cuda)) == 0
    assert mha_lanes.launches_bwd == before + 44
    assert all(torch.equal(dq, first[0]) for dq, _ in runs)
    assert all(torch.equal(dm, first[1]) for _, dm in runs[:40])
    assert all(dm is None for _, dm in runs[40:])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [65, 128, 17])
def test_k1_f32_head_forward_gives_the_same_bits_whatever_the_row_split(cuda, L):
    """The forward splits a head's query rows over several blocks when B *
    heads blocks would leave SMs idle: 4 images alone (split at L = 65 and
    128) give bitwise what the same 4 images give inside a batch of 64 (one
    block a head)."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    rs = np.random.RandomState(6)
    qkv = torch.from_numpy(rs.randn(64, L, 192).astype(np.float32)).to(cuda)
    m = torch.where(torch.arange(L) < L - L // 5, 0.0, -1e9).to(cuda)
    alone = mha_lanes.fused_mha_lanes_qkv(qkv[:4].contiguous(), m, 4, 0.25)
    batch = mha_lanes.fused_mha_lanes_qkv(qkv, m, 4, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:4])


# pairs, trips, trim, kind of icp_inputs; 1024 points a cloud as served
ICP_CASES = [(1, 48, 0.6, "mixed"), (8, 48, 0.6, "mixed"), (3, 48, 0.6, "mixed"),
             (8, 1, 0.6, "invalid"), (3, 8, 0.7, "invalid"), (8, 8, 0.7, "mixed"),
             (1, 1, 0.7, "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("P,iters,trim,kind", ICP_CASES)
def test_icp_graphs_give_the_eager_loops_bits(cuda, P, iters, trim, kind):
    """``masked_icp`` on the card replays CUDA graphs; its poses are the
    eager loop's bits and those of the loop before it was split into steps,
    degenerate and all-invalid pairs included."""
    from _torch_helpers import icp_inputs, parent_masked_icp
    from oryon_tpu_torch.geometry import kabsch

    inputs = icp_inputs(P, 1024, 1024, seed=100 + P + iters, kind=kind, device=cuda)
    with torch.inference_mode():      # as the pipeline calls it
        got = kabsch.masked_icp(*inputs, iters=iters, trim=trim)
    eager = kabsch._masked_icp_eager(*inputs, iters, trim)
    parent = parent_masked_icp(*inputs, iters=iters, trim=trim)
    assert torch.equal(got, eager) and torch.equal(got, parent)
    if kind == "invalid":
        assert torch.equal(got, inputs[4])


@pytest.mark.cuda
def test_icp_graphs_refresh_their_inputs_call_after_call(cuda):
    """Five calls in a row at one shape with other inputs each: every pose
    is the eager loop's bits, so each call reads its own inputs; one capture,
    five replays."""
    from _torch_helpers import icp_inputs
    from oryon_tpu_torch.geometry import kabsch
    from oryon_tpu_torch.utils import profiling

    kabsch._ICP_GRAPHS.clear()
    was = profiling.set_spans(True)
    try:
        outs = []
        for seed in range(5):
            inputs = icp_inputs(8, 1024, 1024, seed=200 + seed, device=cuda)
            with torch.inference_mode():
                outs.append((kabsch.masked_icp(*inputs, iters=48, trim=0.6),
                             kabsch._masked_icp_eager(*inputs, 48, 0.6)))
        counters = profiling.take_counters()
    finally:
        profiling.set_spans(was)
        profiling.take_spans()
    assert all(torch.equal(got, eager) for got, eager in outs)
    assert not torch.equal(outs[0][0], outs[1][0])
    assert counters == {"icp_graph_capture": 1, "icp_graph_replay": 5}


@pytest.mark.cuda
def test_icp_graphs_capture_a_shape_once(cuda):
    """A second shape captures once and the first is not captured again; a
    call that needs gradients runs eagerly; past four shapes the least
    recently used is dropped and captured again when it comes back."""
    from _torch_helpers import icp_inputs
    from oryon_tpu_torch.geometry import kabsch
    from oryon_tpu_torch.utils import profiling

    kabsch._ICP_GRAPHS.clear()
    a = icp_inputs(2, 256, 192, seed=1, device=cuda)
    b = icp_inputs(5, 256, 192, seed=2, device=cuda)
    was = profiling.set_spans(True)
    try:
        got = [kabsch.masked_icp(*a, iters=4), kabsch.masked_icp(*a, iters=6),
               kabsch.masked_icp(*b, iters=4), kabsch.masked_icp(*a, iters=4)]
        src = a[0].clone().requires_grad_()
        kabsch.masked_icp(src, *a[1:], iters=2)
        first = profiling.take_counters()
        names = [r.name for r in profiling.take_spans()]
        for P in (1, 3, 4):                       # three more shapes: five in all
            kabsch.masked_icp(*icp_inputs(P, 64, 64, seed=P, device=cuda), iters=2)
        assert len(kabsch._ICP_GRAPHS) == 4       # b's dropped, a's kept
        again = [kabsch.masked_icp(*a, iters=4), kabsch.masked_icp(*b, iters=4)]
        second = profiling.take_counters()
    finally:
        profiling.set_spans(was)
        profiling.take_spans()
    assert first == {"icp_graph_capture": 2, "icp_graph_replay": 4, "icp_eager": 1}
    assert names.count("icp.capture") == 2
    assert second == {"icp_graph_capture": 4, "icp_graph_replay": 5}
    assert torch.equal(got[0], got[3]) and torch.equal(again[0], got[0])
    assert torch.equal(again[1], got[2])
    assert torch.equal(got[1], kabsch._masked_icp_eager(*a, 6, 0.7))
    assert torch.equal(got[2], kabsch._masked_icp_eager(*b, 4, 0.7))
