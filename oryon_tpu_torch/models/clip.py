"""CLIP ViT image and text towers (NHWC in, bf16 compute).

Counterpart of ``oryon_tpu/models/clip.py``: patch conv, class token, pre-LN
transformer with QuickGELU MLPs, ln_post over the patch tokens (CLS
dropped), and EOT-pooled projected text embeddings.  Module and parameter
names follow the flax tree so ``models.convert.from_jax_params`` is a plain
layout map; the 24 (or 12) scanned blocks become a ``ModuleList``.

``ClipVisionConfig.attn_impl`` chooses the vision tower's attention, with
the JAX package's value names:

* ``fused`` (default): kernel K1 (``ops/cuda/mha_lanes.py``) reads the packed
  in_proj output directly.  The JAX tower pads L from 577 to 640 once and
  masks the pad keys because its TPU kernel wants lane-aligned L; the CUDA
  kernel masks ragged tiles itself, so the port runs the 577 real tokens
  unpadded (masked pad keys add exactly zero weight, so real-token outputs
  do not change).
* ``fused_i8qk``: kernel K1-i8, the same with int8 logits.  Its per-head
  absmax scales are taken over every row of the sequence, so here the tower
  pads 577 -> 640 and passes ``seg`` exactly as the JAX tower does: the
  scales must see the same rows or the result is a different function.
* ``flash``: kernel K5 (``ops/cuda/flash.py``) on [B, H, L, D] after the
  head-split transposes, padded the same way, padding isolated by segment
  ids.
* ``einsum`` / ``auto``: plain PyTorch, the only path that takes a mask.
* ``noattn``: a profiling floor, not an attention.

``ClipVisionConfig.block = "eva02"`` builds the EVA02-CLIP vision tower
instead (Sun et al., "EVA-CLIP", arXiv:2303.15389; ``eva_vit_model.py`` and
``rope.py`` of github.com/baaivision/EVA, EVA-CLIP): q|k|v from one
bias-free projection plus q's and v's own biases, a 2D rotary embedding on q
and k of the patch tokens (kernel R1, ``ops/cuda/rope.py``) ahead of K1, a
sub-LN on the attention output before ``proj``, a SwiGLU MLP with a sub-LN
over its hidden width, LayerNorm eps 1e-6, a patch convolution with a bias,
no ``ln_pre``, and the final ``norm`` over the patch tokens.  Its attention
takes ``fused`` (K1; R1 on the card, the plain rotary on the CPU) and
``einsum`` / ``auto`` (the plain rotary).  ``ClipTextConfig.act = "gelu"``
gives the EVA02-CLIP text tower: CLIP's with exact GELU in its MLPs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from oryon_tpu_torch.models.layers import Conv, Dense, LayerNorm, dense_cls
from oryon_tpu_torch.ops.cuda.flash import flash_mha, flash_mha_padded
from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv
from oryon_tpu_torch.ops.cuda.rope import rope_qk_, rope_qk_plain_
from oryon_tpu_torch.utils.profiling import span

ATTN_IMPLS = ("fused", "fused_i8qk", "flash", "einsum", "auto", "noattn")
PADDED_IMPLS = ("fused_i8qk", "flash")   # the tower pads L to a multiple of 128
VISION_BLOCKS = ("clip", "eva02")
EVA_ATTN_IMPLS = ("fused", "einsum", "auto")
# EVA02-CLIP-L-14-336.json: the SwiGLU's mlp_ratio (hidden 2730 at width
# 1024), the rotary's pretraining grid (pt_hw_seq_len), every LayerNorm's eps
EVA_MLP_RATIO, EVA_PT_GRID, EVA_EPS = 2.6667, 16, 1e-6


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    attn_impl: str = "fused"   # fused | fused_i8qk | flash | einsum | auto | noattn
    quant: str = "none"        # none | int8
    block: str = "clip"        # clip | eva02

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 768
    act: str = "quick_gelu"    # the MLPs' activation: quick_gelu | gelu (exact, erf)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def einsum_attention(q, k, v, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Plain softmax attention on [B, H, L, hd] heads: logits in ``dtype``,
    softmax in f32, probabilities cast back."""
    attn = torch.einsum("bhld,bhmd->bhlm", q, k) * (q.shape[-1] ** -0.5)
    if mask is not None:
        attn = attn + mask.to(attn.dtype)
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    return torch.einsum("bhlm,bhmd->bhld", attn, v)


def _key_mask(seg: Optional[torch.Tensor], L: int, device) -> torch.Tensor:
    """The one [L] additive key mask of the fused kernels from batch-uniform
    padding segment ids: a 1-D [L] vector, or [B, L] with identical rows."""
    if seg is None:
        return torch.zeros(L, dtype=torch.float32, device=device)
    if seg.dim() == 2:
        if not bool((seg == seg[:1]).all()):
            raise ValueError("attn_impl='fused' got per-sample segment ids "
                             "(rows differ); use attn_impl='auto'.")
        seg = seg[0]
    elif seg.dim() != 1:
        raise ValueError(f"seg must be [L] or [B, L], got shape {tuple(seg.shape)}")
    return torch.where(seg > 0, 0.0, -1e9).to(torch.float32)


class MultiHeadAttention(nn.Module):
    """Packed-QKV multi-head attention (torch nn.MultiheadAttention layout).

    ``seg`` holds batch-uniform padding segment ids (1 real, 0 padding) for
    a sequence the caller padded; the fused kernels derive one key mask from
    it, so per-sample segments raise."""

    def __init__(self, width: int, heads: int, dtype=torch.bfloat16,
                 attn_impl: str = "auto", quant: str = "none"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        Dense = dense_cls(quant)
        self.in_proj = Dense(width, 3 * width, dtype)
        self.out_proj = Dense(width, width, dtype)
        self.heads, self.dtype, self.attn_impl = heads, dtype, attn_impl
        self.head_dim = width // heads

    def shard_heads(self, n: int, r: int, group) -> None:
        """Keep this rank's heads/n heads (``parallel.tp.shard_params_tp``
        made ``in_proj`` column-parallel with their q, k and v rows)."""
        self.heads //= n

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, _ = x.shape
        hd = self.head_dim
        D = self.heads * hd      # this rank's heads: all of them unless sharded
        qkv = self.in_proj(x)
        if self.attn_impl in ("fused", "fused_i8qk"):
            if mask is not None:
                raise ValueError("the fused path is unmasked attention only")
            out = fused_mha_lanes_qkv(
                qkv.contiguous(), _key_mask(seg, L, x.device), self.heads,
                hd ** -0.5, qk_int8=self.attn_impl == "fused_i8qk")
            return self.out_proj(out)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        if self.attn_impl == "flash":
            if mask is not None:
                raise ValueError("the flash path is unmasked attention only")
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if seg is not None:
                seg2 = seg.expand(B, L) if seg.dim() == 1 else seg
                out = flash_mha_padded(q, k, v, hd ** -0.5,
                                       seg2.to(torch.int32).contiguous())
            else:
                out = flash_mha(q, k, v, hd ** -0.5)
        elif self.attn_impl == "noattn":
            # profiling floor: no score or value products; not an attention
            out = v + 0.0 * q
        else:
            out = einsum_attention(q, k, v, mask, self.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.bfloat16,
                 attn_impl: str = "auto", quant: str = "none", act: str = "quick_gelu"):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"activation {act!r} not in {tuple(ACTIVATIONS)}")
        Dense = dense_cls(quant)
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, dtype, attn_impl, quant)
        self.ln_2 = LayerNorm(width)
        self.mlp_c_fc = Dense(width, 4 * width, dtype)
        self.mlp_c_proj = Dense(4 * width, width, dtype)
        self.act = ACTIVATIONS[act]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask, seg)
        h = self.act(self.mlp_c_fc(self.ln_2(x)))
        return x + self.mlp_c_proj(h)


class ClipVisionTower(nn.Module):
    """Dense visual tokens: [B, 336, 336, 3] -> [B, 24, 24, 1024] (f32)."""

    def __init__(self, cfg: ClipVisionConfig = ClipVisionConfig(),
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        # remat: under autograd each block is recomputed in backward
        # instead of keeping its activations (non-reentrant checkpoint)
        self.dtype, self.remat = dtype, remat
        self.conv1 = Conv(3, c.width, c.patch_size, stride=c.patch_size,
                          bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(c.grid * c.grid + 1, c.width))
        self.ln_pre = LayerNorm(c.width)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(c.width, c.heads, dtype, c.attn_impl, c.quant)
            for _ in range(c.layers))
        self.ln_post = LayerNorm(c.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B = x.shape[0]
        x = self.conv1(x).reshape(B, c.grid * c.grid, c.width)
        cls = self.class_embedding.to(self.dtype).expand(B, 1, c.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        x = self.ln_pre(x).to(self.dtype)
        seg = None
        L = x.shape[1]
        if c.attn_impl in PADDED_IMPLS:
            # pad the sequence to a multiple of 128 once, outside the layer
            # loop, and isolate the pad tokens with segment ids, as the JAX
            # tower does; the pad rows are dropped after the stack
            Lp = -(-L // 128) * 128
            x = torch.nn.functional.pad(x, (0, 0, 0, Lp - L))
            seg = (torch.arange(Lp, device=x.device) < L).to(torch.int32)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.resblocks:
            x = (checkpoint(block, x, None, seg, use_reentrant=False) if remat
                 else block(x, None, seg))
        toks = self.ln_post(x[:, 1:L])
        return toks.reshape(B, c.grid, c.grid, c.width)


def rope_tables(head_dim: int, grid: int, pt_grid: int, theta: float = 10000.0):
    """(cos, sin), each [grid * grid, head_dim] f32: EVA02's 2D rotary
    (``VisionRotaryEmbeddingFast``) for the patch tokens in row-major order.
    head_dim / 4 frequencies theta^(-2i / (head_dim / 2)) at the positions
    arange(grid) / grid * pt_grid (the pretraining grid interpolated to this
    one), each repeated for an interleaved pair (2i, 2i + 1); dims
    [0, head_dim / 2) carry the row's angles, the rest the column's.  Formed
    in float64 and rounded once (EVA forms them in float32: an f32 ulp
    apart)."""
    half = head_dim // 2
    freqs = theta ** (-np.arange(0, half, 2, dtype=np.float64) / half)
    pos = np.arange(grid, dtype=np.float64) / grid * pt_grid
    ang = np.repeat(np.outer(pos, freqs), 2, axis=1)                    # [grid, half]
    full = np.concatenate([np.broadcast_to(ang[:, None], (grid, grid, half)),
                           np.broadcast_to(ang[None, :], (grid, grid, half))], axis=-1)
    full = full.reshape(grid * grid, head_dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


class EvaAttention(nn.Module):
    """EVA02 attention on the packed q|k|v: one bias-free ``in_proj`` with
    q's and v's own biases (one [3C] bias whose k third is zero), the 2D
    rotary on q and k of the patch rows, softmax attention at scale hd^-0.5,
    then the sub-LN ``inner_attn_ln`` and ``proj``."""

    def __init__(self, width: int, heads: int, dtype=torch.bfloat16, attn_impl: str = "fused"):
        super().__init__()
        if attn_impl not in EVA_ATTN_IMPLS:
            raise ValueError(f"the EVA02 tower's attn_impl {attn_impl!r} not in "
                             f"{EVA_ATTN_IMPLS}")
        self.in_proj = Dense(width, 3 * width, dtype, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(width))
        self.v_bias = nn.Parameter(torch.zeros(width))
        self.inner_attn_ln = LayerNorm(width, EVA_EPS)
        self.proj = Dense(width, width, dtype)
        self.heads, self.dtype, self.attn_impl = heads, dtype, attn_impl
        self.head_dim = width // heads

    def shard_heads(self, n: int, r: int, group) -> None:
        raise ValueError("the EVA02 tower has no tensor-parallel path: its sub-LN "
                         "normalises over every head's channels together")

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        B, L, C = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x.to(self.dtype), self.in_proj.weight.to(self.dtype),
                       bias.to(self.dtype))
        if self.attn_impl == "fused":
            rope_qk_(qkv, *rope, self.heads)
            out = fused_mha_lanes_qkv(qkv, _key_mask(None, L, x.device), self.heads,
                                      self.head_dim ** -0.5)
        else:
            rope_qk_plain_(qkv, *rope, self.heads)
            q, k, v = (t.reshape(B, L, self.heads, self.head_dim).transpose(1, 2)
                       for t in qkv.split(C, dim=-1))
            out = einsum_attention(q, k, v, None, self.dtype).transpose(1, 2).reshape(B, L, C)
        return self.proj(self.inner_attn_ln(out))


class EvaSwiGLU(nn.Module):
    """w3(ffn_ln(silu(w1 x) * w2 x)), the sub-LN over the hidden width."""

    def __init__(self, width: int, hidden: int, dtype=torch.bfloat16):
        super().__init__()
        self.w1 = Dense(width, hidden, dtype)
        self.w2 = Dense(width, hidden, dtype)
        self.ffn_ln = LayerNorm(hidden, EVA_EPS)
        self.w3 = Dense(hidden, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EvaBlock(nn.Module):
    """Pre-LN EVA02 block without layer scale."""

    def __init__(self, width: int, heads: int, hidden: int, dtype=torch.bfloat16,
                 attn_impl: str = "fused"):
        super().__init__()
        self.norm1 = LayerNorm(width, EVA_EPS)
        self.attn = EvaAttention(width, heads, dtype, attn_impl)
        self.norm2 = LayerNorm(width, EVA_EPS)
        self.mlp = EvaSwiGLU(width, hidden, dtype)

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class EvaVisionTower(nn.Module):
    """EVA02-CLIP dense visual tokens: [B, 336, 336, 3] -> [B, 24, 24, 1024]
    (f32), the patch tokens after the final ``norm`` (class token dropped,
    no ``head``), as Oryon keeps CLIP's after ``ln_post``.  The rotary
    tables are non-persistent buffers.  Frozen and bf16 or f32 only: int8,
    ``remat`` (``train_towers``) and tensor-parallel heads raise.  The
    SwiGLU's hidden width, the rotary's grid and the LayerNorms' eps are
    the published ``EVA_*`` constants, not ``cfg`` keys."""

    def __init__(self, cfg: ClipVisionConfig, dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        if cfg.quant != "none":
            raise ValueError("the EVA02 tower has no int8 path (EVA02-CLIP-L's SwiGLU "
                             "hidden width 2730 is no multiple of 8, which torch._int_mm "
                             "refuses); serve it with quant='none'")
        if remat:
            raise ValueError("the EVA02 tower cannot be trained (train_towers): its rotary "
                             "kernel R1 has no backward")
        c = self.cfg = cfg
        self.dtype = dtype
        self.conv1 = Conv(3, c.width, c.patch_size, stride=c.patch_size, bias=True,
                          dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(torch.empty(c.grid * c.grid + 1, c.width))
        self.resblocks = nn.ModuleList(
            EvaBlock(c.width, c.heads, int(c.width * EVA_MLP_RATIO), dtype, c.attn_impl)
            for _ in range(c.layers))
        self.norm = LayerNorm(c.width, EVA_EPS)
        cos, sin = rope_tables(c.width // c.heads, c.grid, EVA_PT_GRID)
        self.register_buffer("rope_cos", torch.tensor(cos), persistent=False)
        self.register_buffer("rope_sin", torch.tensor(sin), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        with span("vision.eva"):
            B = x.shape[0]
            x = self.conv1(x).reshape(B, c.grid * c.grid, c.width)
            cls = self.class_embedding.to(self.dtype).expand(B, 1, c.width)
            x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
            rope = (self.rope_cos, self.rope_sin)
            for block in self.resblocks:
                x = block(x, rope)
            toks = self.norm(x[:, 1:])
            return toks.reshape(B, c.grid, c.grid, c.width)


def vision_tower(cfg: ClipVisionConfig, dtype=torch.bfloat16, remat: bool = False) -> nn.Module:
    """The vision tower of ``cfg.block``: CLIP's or EVA02's."""
    if cfg.block not in VISION_BLOCKS:
        raise ValueError(f"vision block {cfg.block!r} not in {VISION_BLOCKS}")
    tower = EvaVisionTower if cfg.block == "eva02" else ClipVisionTower
    return tower(cfg, dtype, remat=remat)


class ClipTextTower(nn.Module):
    """Token ids [B, L] -> projected EOT embeddings [B, embed_dim] (f32)."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(),
                 dtype=torch.bfloat16):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(c.width, c.heads, dtype, "auto", act=c.act)
            for _ in range(c.layers))
        self.ln_final = LayerNorm(c.width)
        self.text_projection = nn.Parameter(torch.empty(c.width, c.embed_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        L = self.cfg.context_length
        ids = ids.long()
        x = (self.token_embedding[ids].to(self.dtype)
             + self.positional_embedding.to(self.dtype))
        causal = torch.triu(torch.full((L, L), float("-inf"), device=ids.device),
                            diagonal=1)
        for block in self.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        # pool at the EOT token = the highest token id
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return pooled.float() @ self.text_projection
