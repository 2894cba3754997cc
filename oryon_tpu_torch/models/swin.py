"""Swin-B guidance encoder, stages 1-2 (frozen appearance backbone), NHWC.

Counterpart of ``oryon_tpu/models/swin.py``: patch embed -> stage 1 (2
blocks) -> merge -> stage 2 (2 blocks) -> merge, tapping g3 [96², 128],
g2 [48², 256] and g1 [24², 512].  Window 7, shift 3, relative-position bias,
pre-LN blocks, PatchMerging = LN(4C) + Linear(4C -> 2C).

``SwinConfig.attn_impl`` chooses the window attention, with the JAX
package's value names: ``einsum`` (plain PyTorch, the default), ``pallas``
(kernel K3, ``ops/cuda/swin_attn.packed_window_attention``, on the
partitioned windows), ``band`` (kernel K4, ``band_window_attention``, on the
whole padded map: no window partition or reverse in device memory) and
``noattn`` (a profiling floor, not an attention).  ``stage_pad`` pads each
stage to window multiples once instead of per block; ``quant="int8"`` runs
the projections through ``models/quant.py``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from oryon_tpu_torch.models.layers import Conv, LayerNorm, dense_cls
from oryon_tpu_torch.ops.cuda.swin_attn import (band_window_attention,
                                                packed_window_attention)

ATTN_IMPLS = ("einsum", "pallas", "band", "noattn")


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 128
    depths: Tuple[int, int] = (2, 2)
    heads: Tuple[int, int] = (4, 8)
    window: int = 7
    mlp_ratio: float = 4.0
    attn_impl: str = "einsum"   # einsum | pallas (K3) | band (K4) | noattn
    # pad each stage to window multiples once instead of per block: blocks
    # run at the padded resolution and re-zero the pad region after norm1
    # (the per-block pad writes fresh zeros there), so real-token outputs
    # do not change
    stage_pad: bool = False
    quant: str = "none"         # none | int8 (qkv/proj/MLP/reduction)


def relative_position_index(window: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


def shift_attention_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """[num_windows, w*w, w*w] additive mask for shifted-window attention."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=32)
def _shift_mask(H: int, W: int, w: int, shift: int, device: torch.device):
    with torch.inference_mode(False):     # kept for later calls, see ops/resize._matrix
        return torch.from_numpy(shift_attention_mask(H, W, w, shift)).to(device)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(wins: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def windowed_softmax_attention(q, k, v, heads: int, bias: Optional[torch.Tensor],
                               mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Softmax attention inside windows: q, k, v [Bw, N, C]; bias
    [heads, N, N] or None; mask [nw, N, N] or None (windows of one image
    consecutive).  Logits in ``dtype``, softmax in f32."""
    Bw, N, C = q.shape
    hd = C // heads
    q, k, v = (t.reshape(Bw, N, heads, hd).transpose(1, 2) for t in (q, k, v))
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k) * (hd ** -0.5)
    if bias is not None:
        attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(Bw // nw, nw, heads, N, N) + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(Bw, heads, N, N)
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v).transpose(1, 2).reshape(Bw, N, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, dtype=torch.bfloat16,
                 attn_impl: str = "einsum", quant: str = "none"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        Dense = dense_cls(quant)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window).reshape(-1).astype(np.int64)),
            persistent=False)
        self.heads, self.window, self.dtype = heads, window, dtype
        self.attn_impl = attn_impl

    def _bias(self) -> torch.Tensor:
        N = self.window * self.window
        return self.relative_position_bias_table[self.rel_index].reshape(
            N, N, self.heads).permute(2, 0, 1)

    def _comb(self, mask: Optional[torch.Tensor], nw: int) -> torch.Tensor:
        """[nw, heads, N, N] f32: relative-position bias + shift mask."""
        comb = self._bias()[None].expand(nw, -1, -1, -1)
        if mask is not None:
            comb = comb + mask[:, None]
        return comb.contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                nw: Optional[int] = None) -> torch.Tensor:
        """x: [num_windows*B, w*w, C], or for the "band" impl the whole
        padded/rolled map [B, Hp, Wp, C]; mask: [num_windows, w*w, w*w] or
        None; nw: windows per image (the pallas path needs it when mask is
        None)."""
        hd = x.shape[-1] // self.heads
        qkv = self.qkv(x)
        if self.attn_impl == "band":
            Hp, Wp = x.shape[1:3]
            comb = self._comb(mask, (Hp // self.window) * (Wp // self.window))
            return self.proj(band_window_attention(
                qkv.contiguous(), comb, self.heads, self.window, hd ** -0.5))
        q, k, v = qkv.chunk(3, dim=-1)
        if self.attn_impl == "noattn":
            # profiling floor: no score or value products; not an attention
            return self.proj(v + 0.0 * q)
        if self.attn_impl == "pallas":
            nw_ = mask.shape[0] if mask is not None else nw
            if nw_ is None:
                raise ValueError("pallas window attention needs nw")
            out = packed_window_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                self._comb(mask, nw_), self.heads, hd ** -0.5)
            return self.proj(out)
        out = windowed_softmax_attention(q, k, v, self.heads, self._bias(), mask,
                                         self.dtype)
        return self.proj(out)


class SwinBlock(nn.Module):
    """``real_hw``: the real (unpadded) map size when the caller keeps the
    stage at padded resolution (``SwinConfig.stage_pad``); None = pad and
    crop per block."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, dtype=torch.bfloat16,
                 attn_impl: str = "einsum", quant: str = "none"):
        super().__init__()
        Dense = dense_cls(quant)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window, dtype, attn_impl, quant)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype)
        self.window, self.shift, self.dtype = window, shift, dtype

    def forward(self, x: torch.Tensor,
                real_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        w = self.window
        rH, rW = (H, W) if real_hw is None else real_hw
        shift = self.shift if min(rH, rW) > w else 0
        shortcut = x
        x = self.norm1(x).to(self.dtype)
        if real_hw is not None:
            # the map already has window-multiple shape; the pad region
            # carries the previous block's residual and MLP output, and keys
            # from pad tokens must be zeros
            Hp, Wp = H, W
            if (rH, rW) != (H, W):
                keep = torch.zeros((1, Hp, Wp, 1), dtype=x.dtype, device=x.device)
                keep[:, :rH, :rW] = 1.0
                x = x * keep
        else:
            # pad bottom/right to window multiples (published behaviour)
            Hp, Wp = -(-H // w) * w, -(-W // w) * w
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = _shift_mask(Hp, Wp, w, shift, x.device)
        nw = (Hp // w) * (Wp // w)
        if self.attn.attn_impl == "band":
            # map-level attention: the kernel partitions the windows itself
            x = self.attn(x, mask, nw)
        else:
            x = window_reverse(self.attn(window_partition(x, w), mask, nw),
                               w, B, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if real_hw is None:
            x = x[:, :H, :W]
        x = shortcut + x
        h = self.mlp_fc1(self.norm2(x).to(self.dtype))
        h = self.mlp_fc2(F.gelu(h))
        return x + h


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16, quant: str = "none"):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = dense_cls(quant)(4 * dim, 2 * dim, dtype, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        # published concat order: (0,0), (1,0), (0,1), (1,1)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x).to(self.dtype))


class SwinGuidance(nn.Module):
    """384² RGB -> [g1 [24², 512], g2 [48², 256], g3 [96², 128]] (f32)."""

    def __init__(self, cfg: SwinConfig = SwinConfig(), dtype=torch.bfloat16):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = Conv(3, c.embed_dim, 4, stride=4, dtype=dtype)
        self.patch_norm = LayerNorm(c.embed_dim)
        for s, (depth, dim, heads) in enumerate(
                zip(c.depths, (c.embed_dim, 2 * c.embed_dim), c.heads), start=1):
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", SwinBlock(
                    dim, heads, c.window, 0 if i % 2 == 0 else c.window // 2,
                    c.mlp_ratio, dtype, c.attn_impl, c.quant))
        self.merge1 = PatchMerging(c.embed_dim, dtype, c.quant)
        self.merge2 = PatchMerging(2 * c.embed_dim, dtype, c.quant)

    def _stage(self, x: torch.Tensor, s: int) -> torch.Tensor:
        c = self.cfg
        real_hw = None
        if c.stage_pad:
            H, W = x.shape[1:3]
            Hp, Wp = -(-H // c.window) * c.window, -(-W // c.window) * c.window
            if (Hp, Wp) != (H, W):
                real_hw = (H, W)
                x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        for i in range(c.depths[s - 1]):
            x = getattr(self, f"stage{s}_block{i}")(x, real_hw)
        if real_hw is not None:
            x = x[:, :real_hw[0], :real_hw[1]]
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x)).to(self.dtype)
        x = self._stage(x, 1)
        g3 = x.float()
        x = self.merge1(x)
        g2 = x.float()
        x = self.merge2(self._stage(x, 2))
        return [x.float(), g2, g3]
