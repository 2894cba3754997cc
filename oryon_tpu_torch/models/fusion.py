"""Image-text cost-volume fusion (CATSeg-style aggregator), NHWC.

Counterpart of ``oryon_tpu/models/fusion.py``: CLIP projection, cosine
cost volume over the prompt templates, 7x7 conv embedding, then aggregator
layers of two guided window-attention blocks and a guidance head over pooled
pixels.  The defaults (appearance guidance on, the class transformer with
linear attention) serve; ``FusionConfig`` also holds the ablations of the
JAX package: ``use_appearance_guidance=False`` (the guided blocks' q/k see
the features alone), ``attention_type="full"`` (softmax attention in the
class transformer) and ``guidance_head="mlp" | "none"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from oryon_tpu_torch.geometry.pcd import unit
from oryon_tpu_torch.models.layers import Conv, Dense, LayerNorm
from oryon_tpu_torch.models.swin import (_shift_mask, window_partition,
                                         window_reverse,
                                         windowed_softmax_attention)
from oryon_tpu_torch.ops.resize import resize2d


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    hidden_dim: int = 128
    text_guidance_dim: int = 768
    text_guidance_proj_dim: int = 128
    appearance_guidance_dim: int = 512
    appearance_proj_dim: int = 128
    num_layers: int = 2
    nheads: int = 4
    window: int = 12
    pooling: int = 6
    num_prompts: int = 80
    clip_dim: int = 1024
    clip_proj_dim: int = 768
    use_appearance_guidance: bool = True
    attention_type: str = "linear"   # linear | full
    guidance_head: str = "default"   # default | mlp | none


class GuidedWindowAttention(nn.Module):
    """Window MHA where Q/K see [x; guidance] but V sees only x."""

    def __init__(self, dim: int, in_dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.q = Dense(in_dim, dim, dtype)
        self.k = Dense(in_dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.dim, self.heads, self.dtype = dim, heads, dtype

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        out = windowed_softmax_attention(self.q(x), self.k(x),
                                         self.v(x[..., :self.dim]), self.heads,
                                         None, mask, self.dtype)
        return self.proj(out)


class GuidedSwinBlock(nn.Module):
    def __init__(self, dim: int, guid_dim: int, heads: int, window: int,
                 shift: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = GuidedWindowAttention(dim, dim + guid_dim, heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, 4 * dim, dtype)
        self.mlp_fc2 = Dense(4 * dim, dim, dtype)
        self.window, self.shift, self.dtype = window, shift, dtype

    def forward(self, x: torch.Tensor, guidance: Optional[torch.Tensor]) -> torch.Tensor:
        B, H, W, C = x.shape
        w, shift = self.window, self.shift
        y = self.norm1(x).to(self.dtype)
        if guidance is not None:
            y = torch.cat([y, guidance.to(self.dtype)], dim=-1)
        mask = None
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
            mask = _shift_mask(H, W, w, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, w), mask), w, B, H, W)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + y
        h = F.gelu(self.mlp_fc1(self.norm2(x).to(self.dtype)))
        return x + self.mlp_fc2(h)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """ELU(+1) feature-map linear attention; q [N, L, H, D], k/v [N, S, H, D]."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    s = v.shape[1]
    v = v / s
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * s


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over the key axis; q [N, L, H, D], k/v [N, S, H, D]."""
    qk = torch.einsum("nlhd,nshd->nlsh", q, k) / (q.shape[-1] * 1.0) ** 0.5
    return torch.einsum("nlsh,nshd->nlhd", torch.softmax(qk, dim=2), v)


ATTENTIONS = {"linear": linear_attention, "full": full_attention}


def _pool(x: torch.Tensor, p: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // p, p, W // p, p, C).mean(dim=(2, 4))


class MLPGuidanceHead(nn.Module):
    """The 'mlp' guidance head: pooled features through a Dense + ReLU, the
    projected text guidance added, an MLP residual, upsampled back."""

    def __init__(self, hidden_dim: int, text_dim: int, pooling: int,
                 dtype=torch.bfloat16):
        super().__init__()
        C = hidden_dim
        self.visualconv = Dense(C, C, dtype)
        self.textconv = Dense(text_dim, C, dtype)
        self.mlp_fc1 = Dense(C, 4 * C, dtype)
        self.mlp_fc2 = Dense(4 * C, C, dtype)
        self.pooling, self.dtype = pooling, dtype

    def forward(self, x: torch.Tensor, text_guidance: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        h = F.relu(self.visualconv(_pool(x, self.pooling).to(self.dtype)))
        h = h + F.relu(self.textconv(text_guidance.to(self.dtype)))[:, None, None, :]
        m = self.mlp_fc2(F.relu(self.mlp_fc1(h)))
        up = resize2d(m + h, (H, W), "linear", align_corners=True)
        return x + up.to(x.dtype)


class ClassTransformerLayer(nn.Module):
    """Prompt-group transformer over pooled features with text guidance
    (the group axis T is 1)."""

    def __init__(self, hidden_dim: int, nheads: int, pooling: int,
                 dtype=torch.bfloat16, attention_type: str = "linear"):
        super().__init__()
        C = hidden_dim
        self.norm1 = LayerNorm(C)
        self.q = Dense(2 * C, C, dtype)
        self.k = Dense(2 * C, C, dtype)
        self.v = Dense(C, C, dtype)
        self.norm2 = LayerNorm(C)
        self.mlp_fc1 = Dense(C, 4 * C, dtype)
        self.mlp_fc2 = Dense(4 * C, C, dtype)
        self.nheads, self.pooling, self.dtype = nheads, pooling, dtype
        self.attention = ATTENTIONS[attention_type]

    def forward(self, x: torch.Tensor, text_guidance: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.pooling
        Hp, Wp = H // p, W // p
        tok = _pool(x, p).reshape(B * Hp * Wp, 1, C)
        t = self.norm1(tok).to(self.dtype)
        g = text_guidance[:, None, :].expand(B, Hp * Wp, C).reshape(B * Hp * Wp, 1, C)
        qk_in = torch.cat([t, g.to(self.dtype)], dim=-1)
        hd = C // self.nheads
        q = self.q(qk_in).reshape(-1, 1, self.nheads, hd)
        k = self.k(qk_in).reshape(-1, 1, self.nheads, hd)
        v = self.v(t).reshape(-1, 1, self.nheads, hd)
        tok = tok + self.attention(q, k, v).reshape(-1, 1, C).to(tok.dtype)
        h = self.mlp_fc2(F.relu(self.mlp_fc1(self.norm2(tok).to(self.dtype))))
        tok = tok + h.to(tok.dtype)
        up = resize2d(tok.reshape(B, Hp, Wp, C), (H, W), "linear", align_corners=True)
        return x + up.to(x.dtype)


class AggregatorLayer(nn.Module):
    def __init__(self, cfg: FusionConfig, dtype=torch.bfloat16):
        super().__init__()
        c = cfg
        guid_dim = c.appearance_proj_dim if c.use_appearance_guidance else 0
        if guid_dim:
            self.guidance_norm = LayerNorm(guid_dim)
        self.swin_block1 = GuidedSwinBlock(c.hidden_dim, guid_dim, c.nheads, c.window, 0,
                                           dtype)
        self.swin_block2 = GuidedSwinBlock(c.hidden_dim, guid_dim, c.nheads, c.window,
                                           c.window // 2, dtype)
        if c.guidance_head == "default":
            self.class_transformer = ClassTransformerLayer(c.hidden_dim, c.nheads, c.pooling,
                                                           dtype, c.attention_type)
        elif c.guidance_head == "mlp":
            self.mlp_head = MLPGuidanceHead(c.hidden_dim, c.text_guidance_proj_dim,
                                            c.pooling, dtype)
        elif c.guidance_head != "none":
            raise ValueError(c.guidance_head)

    def forward(self, x, app_guidance, text_guidance):
        g = None if app_guidance is None else self.guidance_norm(app_guidance)
        x = self.swin_block1(x, g)
        x = self.swin_block2(x, g)
        if hasattr(self, "class_transformer"):
            return self.class_transformer(x, text_guidance)
        if hasattr(self, "mlp_head"):
            return self.mlp_head(x, text_guidance)
        return x


class ImageTextFusion(nn.Module):
    """CLIP featmap [B, 24, 24, 1024] + prompt embeddings [B, P, 768] +
    appearance guidance [B, 24, 24, 512] -> fused embedding [B, 24, 24, 128]."""

    def __init__(self, cfg: FusionConfig = FusionConfig(), dtype=torch.bfloat16):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.clip_conv = Dense(c.clip_dim, c.clip_proj_dim, torch.float32)
        self.conv1 = Conv(c.num_prompts, c.hidden_dim, 7, padding=3, dtype=dtype)
        if c.use_appearance_guidance:
            self.guidance_projection = Conv(c.appearance_guidance_dim,
                                            c.appearance_proj_dim, 3, padding=1,
                                            dtype=dtype)
        self.text_guidance_projection = Dense(c.text_guidance_dim,
                                              c.text_guidance_proj_dim, dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", AggregatorLayer(c, dtype))

    def forward(self, img_feats: torch.Tensor, text_feats: torch.Tensor,
                app_guidance: Optional[torch.Tensor]) -> torch.Tensor:
        img = self.clip_conv(img_feats.float())
        txt = text_feats.float()
        txt_n = txt / torch.clamp(torch.linalg.norm(txt, dim=-1, keepdim=True), min=1e-8)
        corr = torch.einsum("bhwc,bpc->bhwp", unit(img), txt_n)
        x = self.conv1(corr)
        proj_guide = None
        if self.cfg.use_appearance_guidance and app_guidance is not None:
            proj_guide = F.relu(self.guidance_projection(app_guidance))
        tg = self.text_guidance_projection(unit(txt.mean(dim=1)))
        tg = F.relu(tg)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, proj_guide, tg)
        return x.float()
