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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from oryon_tpu_torch.models.layers import Conv, LayerNorm, dense_cls
from oryon_tpu_torch.ops.cuda.flash import flash_mha, flash_mha_padded
from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

ATTN_IMPLS = ("fused", "fused_i8qk", "flash", "einsum", "auto", "noattn")
PADDED_IMPLS = ("fused_i8qk", "flash")   # the tower pads L to a multiple of 128


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    attn_impl: str = "fused"   # fused | fused_i8qk | flash | einsum | auto | noattn
    quant: str = "none"        # none | int8

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


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


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
            attn = torch.einsum("bhld,bhmd->bhlm", q, k) * (hd ** -0.5)
            if mask is not None:
                attn = attn + mask.to(attn.dtype)
            attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhlm,bhmd->bhld", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.bfloat16,
                 attn_impl: str = "auto", quant: str = "none"):
        super().__init__()
        Dense = dense_cls(quant)
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, dtype, attn_impl, quant)
        self.ln_2 = LayerNorm(width)
        self.mlp_c_fc = Dense(width, 4 * width, dtype)
        self.mlp_c_proj = Dense(4 * width, width, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask, seg)
        h = quick_gelu(self.mlp_c_fc(self.ln_2(x)))
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
            ResidualAttentionBlock(c.width, c.heads, dtype, "auto")
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
