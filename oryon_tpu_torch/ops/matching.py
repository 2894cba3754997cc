"""Masked nearest-neighbour feature matching, batched over pairs.

Counterpart of ``oryon_tpu/ops/matching.py`` (``nn_correspondences`` under
``vmap``).  Per pair: select up to ``src_capacity`` source pixels inside
mask 1, find each one's nearest target over the whole map 2 with the pixels
outside mask 2 excluded (one launch of the masked-argmin kernel for the whole
batch), keep sources closer than ``dist_th`` and sample ``max_corrs`` of them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from oryon_tpu_torch.geometry.pcd import unit
from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin
from oryon_tpu_torch.ops.sampling import flat_to_yx, masked_sample, masked_select


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """Static matching parameters (reference configs/config.yaml:53-61)."""

    src_capacity: int = 5120
    max_corrs: int = 500
    dist_th: float = 0.25
    # "bf16": inputs rounded to bf16, f32 accumulation (the serving default
    # of the JAX package); "fp32": full precision
    precision: str = "bf16"


class Correspondences(NamedTuple):
    yx: torch.Tensor        # [B, max_corrs, 4] int64 (y1, x1, y2, x2)
    valid: torch.Tensor     # [B, max_corrs] bool
    min_dist: torch.Tensor  # [B, max_corrs] f32 match distance per row


def src_capacity(params: MatchParams, hw: int) -> int:
    """Source slots for an hw-pixel map (clamped for small maps)."""
    return min(params.src_capacity, hw)


def nn_correspondences(
    feats1: torch.Tensor,      # [B, H, W, D]
    feats2: torch.Tensor,      # [B, H, W, D]
    mask1: torch.Tensor,       # [B, H, W] 0/1
    mask2: torch.Tensor,       # [B, H, W] 0/1
    noise_src: torch.Tensor,   # [B, H*W] uniform [0, 1): source selection
    noise_out: torch.Tensor,   # [B, src_cap] uniform [1e-20, 1): output sample
    params: MatchParams = MatchParams(),
) -> Correspondences:
    """Masked NN matching of feature map 1 into feature map 2, per pair.

    Rows are valid when the source pixel is masked AND its best match
    distance is below ``params.dist_th``.
    """
    B, H, W, D = feats1.shape
    cap = src_capacity(params, H * W)
    src_idx, src_valid = masked_select(mask1, noise_src, cap)
    src_yx = flat_to_yx(src_idx, W)
    f1 = feats1.reshape(B, H * W, D).float()
    src_feats = unit(torch.gather(f1, 1, src_idx[..., None].expand(B, cap, D)))
    tgt_feats = unit(feats2.reshape(B, H * W, D).float())
    tgt_bad = mask2.reshape(B, H * W) == 0
    min_d, arg = masked_argmin(src_feats.contiguous(), tgt_feats.contiguous(),
                               tgt_bad.contiguous(), params.precision)
    tgt_yx = flat_to_yx(arg.long(), W)

    good = src_valid & (min_d < params.dist_th)
    sel, sel_valid = masked_sample(good.float(), noise_out, params.max_corrs)
    g2 = sel[..., None].expand(B, params.max_corrs, 2)
    rows = torch.cat([torch.gather(src_yx, 1, g2), torch.gather(tgt_yx, 1, g2)],
                     dim=-1)
    return Correspondences(rows, sel_valid, torch.gather(min_d, 1, sel))


def nn_correspondences_anchors(
    feats1: torch.Tensor,      # [B, H, W, D]
    feats2: torch.Tensor,      # [B, H, W, D]
    anchors: torch.Tensor,     # [B, N, 2] int (y, x) source coordinates
    mask2: torch.Tensor,       # [B, H, W] 0/1
) -> torch.Tensor:
    """Nearest neighbour in map 2 (pixels outside mask 2 excluded) of each
    fixed source pixel of map 1: one launch of the masked-argmin kernel for
    the batch.  Returns [B, N, 4] (y1, x1, y2, x2) int64.  Counterpart of
    the JAX package's ``nn_correspondences_anchors`` (one pair there), whose
    streaming argmin rounds its inputs to bf16, as the bf16 mode does here."""
    B, H, W, D = feats1.shape
    a = anchors.long()
    idx = (a[..., 0] * W + a[..., 1])[..., None].expand(B, a.shape[1], D)
    src = unit(torch.gather(feats1.reshape(B, H * W, D).float(), 1, idx))
    tgt = unit(feats2.reshape(B, H * W, D).float())
    bad = mask2.reshape(B, H * W) == 0
    _, arg = masked_argmin(src.contiguous(), tgt.contiguous(), bad.contiguous(), "bf16")
    return torch.cat([a, flat_to_yx(arg.long(), W)], dim=-1)
