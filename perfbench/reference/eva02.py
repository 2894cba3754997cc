"""Plain PyTorch reference of Oryon with the EVA02-CLIP-L/14@336 towers.

Sun, Fang, Wu, Wang, Cao: "EVA-CLIP: Improved Training Techniques for CLIP at
Scale", arXiv:2303.15389; the configuration ``EVA02-CLIP-L-14-336.json`` and
the model code ``eva_vit_model.py``, ``rope.py``, ``transformer.py`` of
github.com/baaivision/EVA (EVA-CLIP).  ``model.Oryon`` with its two
vision-language towers replaced; Swin, fusion, decoder and ``Prec`` are
``model.py``'s, and so are the layers (``Dense``, ``Conv``, ``LayerNorm``),
so that ``lib/weights.py`` draws the same weights for this module and for
the served model.  Float32 throughout (TF32 off: the harness turns it off
before building either side), plain operations only; it imports nothing of
the program or of JAX.

The vision tower (``vision`` section, ``block`` "eva02"; what the section
does not give is ``EVA02-CLIP-L-14-336.json``'s: ``MLP_RATIO``, ``PT_GRID``,
``EPS``):

- patch convolution with a bias, the class token, absolute position
  embeddings of the grid's tokens and the class token, no ``ln_pre``;
- each block: x + attn(norm1(x)), then x + mlp(norm2(x)); no layer scale;
- attention: q|k|v from one bias-free projection, q's and v's own biases
  (k has none); the 2D rotary on q and k of the patch tokens (the class
  token is not rotated): head dims [0, hd/2) rotated by the token's row y,
  the rest by its column x, pair (2i, 2i + 1) of a half by
  pos * theta^(-2i / (hd / 2)) with pos = y (or x) / grid * PT_GRID;
  ``t * cos + rotate_half(t) * sin``; softmax attention at hd^-0.5; the
  sub-LN ``inner_attn_ln`` on the heads' output, then ``proj``;
- the SwiGLU: w3(ffn_ln(silu(w1 x) * w2 x)), ``ffn_ln`` over the hidden
  width int(width * MLP_RATIO) (2730 at width 1024);
- every LayerNorm with eps ``EPS`` (1e-6).

The text tower (``text`` section, ``act`` "gelu"): CLIP's, with exact (erf)
GELU in its MLPs; LayerNorm eps 1e-5 as in EVA-CLIP's text tower.

Departures from EVA's published code, each where Oryon takes the tower:

- the vision tower returns the patch tokens after the final ``norm``, the
  class token dropped, and has no ``head`` (the 1024 -> 768 projection):
  Oryon's fusion takes the grid of 1024-wide tokens, as it takes CLIP's
  after ``ln_post``;
- EVA's separate ``q_proj`` / ``k_proj`` / ``v_proj`` are one packed
  ``in_proj`` [3C, C] (q, k, v rows in that order), as the served model
  holds them;
- the rotary tables are formed in float64 and rounded to float32 once
  (EVA forms them in float32: an f32 ulp apart).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import model as base
from perfbench.reference.model import Conv, Dense, LayerNorm, Prec, softmax_attention

__all__ = ["Oryon", "build", "Prec", "rope_tables", "rotate"]

MLP_RATIO, PT_GRID, EPS = 2.6667, 16, 1e-6     # mlp_ratio, pt_hw_seq_len, LayerNorm eps


def rope_tables(head_dim: int, grid: int, pt_grid: int, theta: float = 10000.0):
    """(cos, sin) numpy f32 [grid * grid, head_dim] for the patch tokens in
    row-major order (see the module doc)."""
    half = head_dim // 2
    freqs = theta ** (-np.arange(0, half, 2, dtype=np.float64) / half)
    pos = np.arange(grid, dtype=np.float64) / grid * pt_grid
    ang = np.repeat(np.outer(pos, freqs), 2, axis=1)
    full = np.concatenate([np.broadcast_to(ang[:, None], (grid, grid, half)),
                           np.broadcast_to(ang[None, :], (grid, grid, half))], axis=-1)
    full = full.reshape(grid * grid, head_dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> torch.Tensor:
    """The 2D rotary on [B, L, C] (q or k): every head of the patch rows
    1..L-1, the class row as it is."""
    B, L, C = t.shape
    x = t[:, 1:].reshape(B, L - 1, heads, C // heads)
    half = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)
    rot = x * cos[:, None] + half * sin[:, None]
    return torch.cat([t[:, :1], rot.reshape(B, L - 1, C)], dim=1)


class EvaAttention(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.in_proj = Dense(width, 3 * width, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(width))
        self.v_bias = nn.Parameter(torch.zeros(width))
        self.inner_attn_ln = LayerNorm(width, eps)
        self.proj = Dense(width, width)
        self.heads = heads

    def forward(self, x, cos, sin):
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        q, v = q + self.q_bias, v + self.v_bias
        q, k = rotate(q, cos, sin, self.heads), rotate(k, cos, sin, self.heads)
        return self.proj(self.inner_attn_ln(softmax_attention(q, k, v, self.heads)))


class EvaSwiGLU(nn.Module):
    def __init__(self, width: int, hidden: int, eps: float):
        super().__init__()
        self.w1 = Dense(width, hidden)
        self.w2 = Dense(width, hidden)
        self.ffn_ln = LayerNorm(hidden, eps)
        self.w3 = Dense(hidden, width)

    def forward(self, x):
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EvaBlock(nn.Module):
    def __init__(self, width: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(width, eps)
        self.attn = EvaAttention(width, heads, eps)
        self.norm2 = LayerNorm(width, eps)
        self.mlp = EvaSwiGLU(width, hidden, eps)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm1(x), cos, sin)
        return x + self.mlp(self.norm2(x))


class EvaVisionTower(nn.Module):
    """[B, S, S, 3] -> [B, S/p, S/p, width] patch tokens after ``norm``."""

    def __init__(self, c: dict):
        super().__init__()
        self.grid, self.width = c["image_size"] // c["patch_size"], c["width"]
        self.conv1 = Conv(3, c["width"], c["patch_size"], stride=c["patch_size"], bias=True)
        self.class_embedding = nn.Parameter(torch.empty(c["width"]))
        self.positional_embedding = nn.Parameter(torch.empty(self.grid ** 2 + 1, c["width"]))
        hidden = int(c["width"] * MLP_RATIO)
        self.resblocks = nn.ModuleList(EvaBlock(c["width"], c["heads"], hidden, EPS)
                                       for _ in range(c["layers"]))
        self.norm = LayerNorm(c["width"], EPS)
        cos, sin = rope_tables(c["width"] // c["heads"], self.grid, PT_GRID)
        self.register_buffer("rope_cos", torch.tensor(cos), persistent=False)
        self.register_buffer("rope_sin", torch.tensor(sin), persistent=False)

    def forward(self, x):
        B, g, w = x.shape[0], self.grid, self.width
        x = self.conv1(x).reshape(B, g * g, w)
        x = torch.cat([self.class_embedding.expand(B, 1, w), x], 1) + self.positional_embedding
        cos, sin = self.rope_cos.to(x.device), self.rope_sin.to(x.device)
        for blk in self.resblocks:
            x = blk(x, cos, sin)
        return self.norm(x[:, 1:]).reshape(B, g, g, w)


class GeluBlock(base.ResidualAttentionBlock):
    """CLIP's text block with exact GELU in its MLP."""

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp_c_proj(F.gelu(self.mlp_c_fc(self.ln_2(x))))


class EvaTextTower(base.ClipTextTower):
    """Token ids [N, L] -> projected EOT embeddings [N, embed_dim]."""

    def __init__(self, c: dict):
        nn.Module.__init__(self)
        if c.get("act") != "gelu":
            raise ValueError(f"the EVA02-CLIP text tower takes act 'gelu', got {c.get('act')!r}")
        self.L = c["context_length"]
        self.token_embedding = nn.Parameter(torch.empty(c["vocab_size"], c["width"]))
        self.positional_embedding = nn.Parameter(torch.empty(self.L, c["width"]))
        self.resblocks = nn.ModuleList(GeluBlock(c["width"], c["heads"])
                                       for _ in range(c["layers"]))
        self.ln_final = LayerNorm(c["width"])
        self.text_projection = nn.Parameter(torch.empty(c["width"], c["embed_dim"]))


class Oryon(base.Oryon):
    """``model.Oryon`` with the EVA02-CLIP towers (``model`` section of a
    configuration whose vision ``block`` is "eva02")."""

    def __init__(self, cfg: dict):
        nn.Module.__init__(self)
        m = cfg["model"]
        if m["vision"].get("block") != "eva02" or m["quant"] != "none":
            raise ValueError("reference eva02 takes a vision block 'eva02' with quant 'none'")
        self.clip_size, self.swin_size = m["vision"]["image_size"], m["swin_image_size"]
        self.vlm_visual = EvaVisionTower(m["vision"])
        self.vlm_text = EvaTextTower(m["text"])
        self.guidance = base.SwinGuidance(m["swin"])
        self.fusion = base.ImageTextFusion(m["fusion"])
        self.decoder = base.StandardDecoder(m["decoder"])


def build(cfg: dict, device, prec: Optional[Prec] = None) -> Oryon:
    """The reference model with uninitialised parameters on ``device``."""
    with torch.device(device):
        model = Oryon(cfg)
    model.to(device)
    return model.set_precision(prec or Prec()).eval()
