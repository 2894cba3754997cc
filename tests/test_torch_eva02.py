"""The EVA02-CLIP-L/14@336 towers of the port (``models/clip.py``,
``model.image_encoder.vlm=eva02``) against the benchmark's plain reference
``perfbench/reference/eva02.py``, at tiny widths on the CPU in float32; the
2D rotary against its closed form; the config path, the paths out of scope,
the CLIP towers unchanged, the span and the counter.  One ``cuda`` case holds
the rotary kernel R1 against its plain version and skips without a card.
The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eva02.py
"""
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
YAML = os.path.join(ROOT, "configs", "config.yaml")

from oryon_tpu_torch.models import clip  # noqa: E402
from oryon_tpu_torch.models.layers import LayerNorm, random_init_  # noqa: E402
from oryon_tpu_torch.models.oryon import build_model, full_oryon, small_oryon, tiny_oryon  # noqa: E402
from oryon_tpu_torch.ops.cuda import rope as rope_op  # noqa: E402
from oryon_tpu_torch.utils import profiling  # noqa: E402
from perfbench.reference import eva02 as ref  # noqa: E402


def _rel(a, b):
    return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))


def _section(cfg, **extra):
    return {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()
            if f.name not in ("attn_impl", "quant")} | extra


@pytest.fixture(scope="module")
def tiny_eva():
    """tiny_oryon(vlm="eva02") with seeded weights, and every bias, q_bias,
    v_bias and norm scale / shift moved by seeded noise (the seeded rule
    draws them as 0 and 1, which would leave them untested)."""
    model = random_init_(tiny_oryon(vlm="eva02"), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "q_bias", "v_bias")) or p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize("attn_impl", ["fused", "einsum"])
def test_vision_tower_matches_the_reference(tiny_eva, attn_impl):
    tower = tiny_eva.vlm_visual
    for blk in tower.resblocks:
        blk.attn.attn_impl = attn_impl
    r = ref.EvaVisionTower(_section(tiny_eva.vision_cfg))
    r.load_state_dict(tower.state_dict(), strict=True)
    x = torch.randn(3, 56, 56, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, want = tower(x), r(x)
    for blk in tower.resblocks:
        blk.attn.attn_impl = "fused"
    assert got.shape == want.shape == (3, 4, 4, 64)
    assert _rel(got, want) <= 1e-5


def test_text_tower_matches_the_reference(tiny_eva):
    tower = tiny_eva.vlm_text
    assert tower.cfg.act == "gelu"
    r = ref.EvaTextTower(_section(tiny_eva.text_cfg))
    r.load_state_dict(tower.state_dict(), strict=True)
    ids = torch.randint(1, 590, (4, 16), generator=torch.Generator().manual_seed(6))
    ids[:, 9] = 599      # EOT: the highest id
    with torch.no_grad():
        got, want = tower(ids), r(ids)
    assert _rel(got, want) <= 1e-5
    # QuickGELU in its place is another function
    r.resblocks = torch.nn.ModuleList(
        ref.base.ResidualAttentionBlock(32, 4) for _ in range(2)).eval()
    r.load_state_dict(tower.state_dict(), strict=True)
    with torch.no_grad():
        assert _rel(got, r(ids)) > 1e-3


@pytest.mark.parametrize("grid,hd", [(24, 64), (4, 16)])
def test_rotary_matches_its_closed_form(grid, hd):
    """Pair (2i, 2i+1) of the first half of a head is rotated by
    y * 16 / grid * 10000^(-2i / (hd / 2)), of the second half by x; the
    class token is not rotated.  The port's tables are the reference's."""
    heads, C = 2, 2 * hd
    rs = np.random.RandomState(7)
    t = torch.from_numpy(rs.randn(1, 1 + grid * grid, C).astype(np.float32))
    cos, sin = (torch.from_numpy(a) for a in ref.rope_tables(hd, grid, 16))
    for a, b in zip(ref.rope_tables(hd, grid, 16), clip.rope_tables(hd, grid, 16)):
        assert np.array_equal(a, b)
    out = ref.rotate(t, cos, sin, heads).double().numpy()
    x = t.double().numpy()
    assert np.array_equal(out[0, 0], x[0, 0])
    half = hd // 2
    for y, xc in [(0, 0), (0, grid - 1), (grid - 1, 1), (grid // 2, grid // 3)]:
        tok = 1 + y * grid + xc
        for h in range(heads):
            for part, pos in ((0, y), (1, xc)):
                for i in range(half // 2):
                    ang = pos * 16.0 / grid * 10000.0 ** (-2 * i / half)
                    j = h * hd + part * half + 2 * i
                    a, b = x[0, tok, j], x[0, tok, j + 1]
                    want = (a * np.cos(ang) - b * np.sin(ang), b * np.cos(ang) + a * np.sin(ang))
                    assert np.allclose(out[0, tok, j:j + 2], want, rtol=1e-5, atol=1e-5)


def test_plain_rotary_of_the_port_is_the_reference_on_q_and_k():
    B, L, heads, hd = 2, 17, 4, 16
    qkv = torch.randn(B, L, 3 * heads * hd, generator=torch.Generator().manual_seed(8))
    cos, sin = (torch.from_numpy(a) for a in clip.rope_tables(hd, 4, 16))
    got = rope_op.rope_qk_plain_(qkv.clone(), cos, sin, heads)
    q, k, v = qkv.chunk(3, dim=-1)
    want = torch.cat([ref.rotate(q, cos, sin, heads), ref.rotate(k, cos, sin, heads), v], -1)
    assert torch.equal(got, want)


def test_rotary_rejects_shapes_it_cannot_rotate():
    """Both paths of R1 check the packed layout and the tables' shape."""
    cos, sin = (torch.from_numpy(a) for a in clip.rope_tables(16, 4, 16))
    for fn in (rope_op.rope_qk_, rope_op.rope_qk_plain_):
        with pytest.raises(ValueError, match="not \\[B, L, 3C\\]"):
            fn(torch.zeros(2, 17, 3 * 64 + 1), cos, sin, 4)
        with pytest.raises(ValueError, match="not \\[B, L, 3C\\]"):
            fn(torch.zeros(2, 17, 3 * 64), cos, sin, 5)
        with pytest.raises(ValueError, match="tables"):
            fn(torch.zeros(2, 10, 3 * 64), cos, sin, 4)


def test_config_path_builds_the_eva_towers(capsys):
    """``model.image_encoder.vlm=eva02`` through ``model_from_config`` (tiny),
    served by ``OryonPredictor``; at size full the published widths, and
    the pretrained assets report that no EVA02 checkpoint is configured."""
    from oryon_tpu_torch import config as tcfg, infer
    from oryon_tpu_torch.models.pretrained import load_pretrained_params

    cfg = tcfg.load_config(YAML, ["model.size=tiny", "model.image_encoder.vlm=eva02"])
    model, epoch = infer.model_from_config(cfg)
    assert epoch is None and isinstance(model.vlm_visual, clip.EvaVisionTower)
    assert model.text_cfg.act == "gelu"
    assert model.vlm_visual.resblocks[0].mlp.w3.weight.shape == (64, 170)   # int(64 x 2.6667)
    pred = infer.OryonPredictor(model, None, device="cpu", batch_size=1, img_size=(64, 64),
                                depth_hw=(48, 64), n_corrs=64, icp_points=64, icp_iters=2,
                                tokenize_fn=lambda p: np.tile(
                                    np.array([[598, len(p) + 1, 599] + [0] * 13]), (8, 1)))
    rs = np.random.RandomState(4)

    def view():
        return {"rgb": (rs.rand(64, 64, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(48, 64) * 300 + 600).astype(np.float32),
                "camera": [60.0, 60.0, 32.0, 24.0]}
    res = pred.predict_pair(view(), view(), "mug")
    assert np.isfinite(np.asarray(res["pose"])).all()

    full_cfg = tcfg.load_config(YAML, ["model.image_encoder.vlm=eva02"])
    with torch.device("meta"):
        full = build_model("full", vlm="eva02")
    v = full.vision_cfg
    assert (v.image_size, v.patch_size, v.width, v.layers, v.heads,
            v.block) == (336, 14, 1024, 24, 16, "eva02")
    assert full.vlm_visual.resblocks[0].mlp.w3.weight.shape == (1024, 2730)
    norms = [m for m in full.vlm_visual.modules() if isinstance(m, LayerNorm)]
    assert len(norms) == 4 * 24 + 1 and {m.eps for m in norms} == {1e-6}
    t = full.text_cfg
    assert (t.vocab_size, t.context_length, t.width, t.layers, t.heads, t.embed_dim,
            t.act) == (49408, 77, 768, 12, 12, 768, "gelu")
    towers = sum(p.numel() for m in (full.vlm_visual, full.vlm_text) for p in m.parameters())
    assert towers == 427_295_936
    report = load_pretrained_params(full_cfg, full)
    assert "no EVA02 checkpoint is configured" in report[0]
    assert not any("CLIP" in line and "loaded" in line for line in report)


def test_paths_out_of_scope_raise():
    with torch.device("meta"):
        with pytest.raises(ValueError, match="int8"):
            build_model("full", quant="int8", vlm="eva02")
        with pytest.raises(ValueError, match="attn_impl"):
            full_oryon(attn_impl="fused_i8qk", vlm="eva02")
    with pytest.raises(ValueError, match="train_towers"):
        build_model("tiny", train_towers=True, vlm="eva02")
    with pytest.raises(ValueError, match="tensor-parallel"):
        tiny_oryon(vlm="eva02").vlm_visual.resblocks[0].attn.shard_heads(2, 0, None)
    with pytest.raises(ValueError, match="vlm"):
        build_model("tiny", vlm="siglip")


# sha256 of the sorted (name, shape) pairs of the state dict, its length and
# the parameter count, of each CLIP factory as it stood before the EVA02 tower
CLIP_LAYOUT = {"full": ("2d0e39063c78a336", 640, 433449433),
               "small": ("75f1a4a0e50aa08b", 256, 8380249),
               "tiny": ("98ebdb52d5cde0a6", 256, 5149577)}


@pytest.mark.parametrize("size", sorted(CLIP_LAYOUT))
def test_clip_defaults_keep_their_parameters(size):
    factory = {"full": full_oryon, "small": small_oryon, "tiny": tiny_oryon}[size]
    with torch.device("meta"):
        m = factory()
    items = sorted((n, tuple(p.shape)) for n, p in m.state_dict().items())
    digest = hashlib.sha256(repr(items).encode()).hexdigest()[:16]
    assert (digest, len(items), sum(p.numel() for p in m.parameters())) == CLIP_LAYOUT[size]
    assert isinstance(m.vlm_visual, clip.ClipVisionTower)
    assert all(b.act is clip.quick_gelu for b in m.vlm_text.resblocks)


def test_span_and_counter_only_while_spans_are_on(tiny_eva):
    x = torch.randn(2, 56, 56, 3)
    profiling.take_spans(), profiling.take_counters()
    was = profiling.set_spans(True)
    try:
        with torch.no_grad():
            tiny_eva.vlm_visual(x)
        spans, counters = profiling.take_spans(), profiling.take_counters()
    finally:
        profiling.set_spans(was)
    assert [s.name for s in spans] == ["vision.eva"]
    assert counters == {"rope_plain": tiny_eva.vision_cfg.layers}
    with torch.no_grad():
        tiny_eva.vlm_visual(x)
    assert profiling.take_spans() == [] and profiling.take_counters() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (16, 577, 16, 64)),
                                         (torch.bfloat16, (3, 17, 4, 16)),
                                         (torch.float32, (2, 17, 4, 16))])
def test_rotary_kernel_matches_plain(dtype, shape):
    """R1 against the plain version on the card: the same bits (each product
    and the sum rounded on its own, one rounding to the storage type), the
    class row and v untouched, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, L, heads, hd = shape
    grid = int(round((L - 1) ** 0.5))
    g = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn(B, L, 3 * heads * hd, generator=g, device="cuda").to(dtype)
    cos, sin = (torch.from_numpy(a).cuda() for a in clip.rope_tables(hd, grid, 16))
    before = rope_op.launches
    got = rope_op.rope_qk_(qkv.clone(), cos, sin, heads)
    want = rope_op.rope_qk_plain_(qkv.clone(), cos, sin, heads)
    torch.cuda.synchronize()
    assert rope_op.launches == before + 1
    assert torch.equal(got, want)
    C = heads * hd
    assert torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[..., 2 * C:], qkv[..., 2 * C:])
