"""Contrastive feature loss and mask loss over a pair batch.

Counterpart of ``oryon_tpu/losses/feature_loss.py``:

* positives: the featmaps gathered at the ground-truth correspondences,
  scaled from input to featmap resolution and clamped per axis;
* hardest negatives: for each positive, the most similar feature in a pool
  of pixels (the whole featmap when it has at most ``neg_pool`` pixels, else
  ``neg_pool`` drawn uniformly), excluding pixels within ``neg_kernel`` px by
  a ``+1e6 * relu(kernel - pixdist)`` penalty, ``pixdist = sqrt(d2 + 1e-7)``;
  or, with ``hard_negatives=False``, one uniformly drawn pixel a positive;
* margins pos 0.2 / neg 0.9 on the inverted cosine distance;
* the mask loss at featmap resolution against the nearest-resized ground
  truth, and the IoU of the thresholded prediction.

Per-correspondence and per-pair validity weight the means.  The draws come
from ``generator``, or are given as ``draws`` (the indices the JAX package
drew, for parity).  The [B, N, pool] distance matrix is built without
autograd: only the gather of the chosen negatives carries a gradient, as
the JAX package's argmin does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from oryon_tpu_torch.eval.metrics import mask_iou
from oryon_tpu_torch.geometry.pcd import unit
from oryon_tpu_torch.losses.mask_losses import MASK_LOSSES
from oryon_tpu_torch.ops.resize import resize_mask_nearest
from oryon_tpu_torch.parallel.mesh import all_reduce_, group_size


@dataclasses.dataclass(frozen=True)
class FeatureLossConfig:
    pos_margin: float = 0.2
    neg_margin: float = 0.9
    neg_kernel: float = 5.0
    neg_pool: int = 2048
    hard_negatives: bool = True
    mask_type: str = "dice"
    mask_threshold: float = 0.5
    w_mask: float = 1.0
    w_pos: float = 0.5
    w_neg: float = 0.5


class LossOutputs(NamedTuple):
    total: torch.Tensor
    losses: Dict[str, torch.Tensor]     # weighted components: mask/pos/neg
    iou_a: torch.Tensor                 # [B]
    iou_q: torch.Tensor
    pred_mask_a: torch.Tensor           # [B, H, W] thresholded
    pred_mask_q: torch.Tensor


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, D], idx [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _gather_feats(featmap: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """featmap [B, H, W, D], yx [B, N, 2] integer -> [B, N, D]."""
    B, H, W, D = featmap.shape
    return _rows(featmap.reshape(B, H * W, D), yx[..., 0] * W + yx[..., 1])


def _cos_dist(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverted normalised cosine distance along the last axis."""
    return 0.5 * (1.0 - torch.sum(unit(a, eps) * unit(b, eps), dim=-1))


def draw_indices(generator: torch.Generator, featmap_hw: Tuple[int, int], B: int,
                 N: int, cfg: FeatureLossConfig) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The (anchor, query) index draws of one ``feature_loss`` call, on the
    generator's device: pools [B, neg_pool] for hard negatives (None when
    the whole featmap is the pool), else one pixel [B, N] a positive."""
    HW = featmap_hw[0] * featmap_hw[1]
    if cfg.hard_negatives and HW <= cfg.neg_pool:
        return None
    shape = (B, cfg.neg_pool) if cfg.hard_negatives else (B, N)
    return tuple(torch.randint(0, HW, shape, generator=generator,
                               device=generator.device) for _ in range(2))


def _hardest_negatives(pos_feats: torch.Tensor, pos_yx: torch.Tensor,
                       featmap: torch.Tensor, pool_idx: Optional[torch.Tensor],
                       cfg: FeatureLossConfig) -> torch.Tensor:
    """For each positive [B, N, D] at pos_yx [B, N, 2] (f32), the most
    similar pool feature outside the neg_kernel radius: [B, N, D]."""
    B, H, W, D = featmap.shape
    if pool_idx is None:
        pool_idx = torch.arange(H * W, device=featmap.device).expand(B, H * W)
    pool_feats = _rows(featmap.reshape(B, H * W, D), pool_idx)
    with torch.no_grad():
        pool_yx = torch.stack([pool_idx // W, pool_idx % W], dim=-1).float()
        feat_dist = 0.5 * (1.0 - torch.einsum("bnd,bkd->bnk", unit(pos_feats),
                                              unit(pool_feats)))
        d2 = torch.sum((pos_yx[:, :, None, :] - pool_yx[:, None, :, :]) ** 2, dim=-1)
        pix_dist = torch.sqrt(d2 + 1e-7)
        feat_dist = feat_dist + 1e6 * torch.relu(cfg.neg_kernel - pix_dist)
        neg_idx = torch.argmin(feat_dist, dim=-1)                 # [B, N]
    return _rows(pool_feats, neg_idx)


def feature_loss(
    featmap_a: torch.Tensor,     # [B, H, W, D]
    featmap_q: torch.Tensor,
    mask_logits_a: torch.Tensor,  # [B, H, W]
    mask_logits_q: torch.Tensor,
    gt_mask_a: torch.Tensor,     # [B, Hm, Wm] at input resolution
    gt_mask_q: torch.Tensor,
    corrs: torch.Tensor,         # [B, N, 4] integer (y1, x1, y2, x2) at input resolution
    corr_valid: torch.Tensor,    # [B, N] per-row validity
    sample_valid: torch.Tensor,  # [B] per-pair validity
    input_hw: Tuple[int, int],
    generator: Optional[torch.Generator] = None,
    cfg: FeatureLossConfig = FeatureLossConfig(),
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    group=None,
) -> LossOutputs:
    """The loss of one batch.  ``draws``: the (anchor, query) indices of
    ``draw_indices``; drawn from ``generator`` when not given.

    ``group``: the data group of a batch split over ranks (this rank holds
    an equal share of its pairs).  The loss is then this rank's share of the
    global batch's loss, so that the shares sum to it over the group: the
    correspondence losses are normalised by the global count of valid pairs
    (a mean of the ranks' means would weigh a pair by how many valid pairs
    share its rank) and the mask loss, a plain mean, is divided by the
    group's size."""
    B, H, W, D = featmap_a.shape
    dev = featmap_a.device
    # input to featmap resolution by f32 ratios, then a per-axis clamp (rows
    # are y1, x1, y2, x2): scalars only, so no host-to-device copy
    ry = float(np.float32(H) / np.float32(input_hw[0]))
    rx = float(np.float32(W) / np.float32(input_hw[1]))
    y1, x1, y2, x2 = corrs.float().unbind(-1)
    fc = torch.stack([(y1 * ry).clamp(0, H - 1), (x1 * rx).clamp(0, W - 1),
                      (y2 * ry).clamp(0, H - 1), (x2 * rx).clamp(0, W - 1)], dim=-1).long()
    ca, cq = fc[..., :2], fc[..., 2:]

    pos_a = _gather_feats(featmap_a, ca)
    pos_q = _gather_feats(featmap_q, cq)

    if draws is None and (not cfg.hard_negatives or H * W > cfg.neg_pool):
        if generator is None:
            raise ValueError("feature_loss draws indices: pass a generator or draws")
        draws = draw_indices(generator, (H, W), B, pos_a.shape[1], cfg)
    idx_a, idx_q = (None, None) if draws is None else (d.to(dev) for d in draws)
    if cfg.hard_negatives:
        neg_a = _hardest_negatives(pos_a, ca.float(), featmap_a, idx_a, cfg)
        neg_q = _hardest_negatives(pos_q, cq.float(), featmap_q, idx_q, cfg)
    else:
        neg_a = _rows(featmap_a.reshape(B, H * W, D), idx_a)
        neg_q = _rows(featmap_q.reshape(B, H * W, D), idx_q)

    dist_pos = _cos_dist(pos_a, pos_q)        # [B, N]
    dist_na = _cos_dist(pos_a, neg_a)
    dist_nq = _cos_dist(pos_q, neg_q)

    pos_l = torch.relu(dist_pos - cfg.pos_margin)
    neg_la = torch.relu(cfg.neg_margin - dist_na)
    neg_lq = torch.relu(cfg.neg_margin - dist_nq)

    cw = corr_valid.float()
    cw_sum = torch.clamp(torch.sum(cw, dim=1), min=1.0)
    sv = torch.as_tensor(sample_valid, device=dev).float()
    sv_sum = torch.sum(sv)
    if group is not None:
        sv_sum = all_reduce_(sv_sum.clone(), group)
    sv_sum = torch.clamp(sv_sum, min=1.0)

    def reduce(per_corr):
        per_sample = torch.sum(per_corr * cw, dim=1) / cw_sum
        return torch.sum(per_sample * sv) / sv_sum

    pos_loss = reduce(pos_l)
    neg_loss = 0.5 * (reduce(neg_la) + reduce(neg_lq))

    mask_fn = MASK_LOSSES[cfg.mask_type]
    gt_a = resize_mask_nearest(gt_mask_a, (H, W)).float()
    gt_q = resize_mask_nearest(gt_mask_q, (H, W)).float()
    mask_loss = 0.5 * (mask_fn(mask_logits_a, gt_a) + mask_fn(mask_logits_q, gt_q))
    if group is not None:
        mask_loss = mask_loss / group_size(group)

    with torch.no_grad():
        pred_a = (torch.sigmoid(mask_logits_a) > cfg.mask_threshold).int()
        pred_q = (torch.sigmoid(mask_logits_q) > cfg.mask_threshold).int()
        iou_a = mask_iou(gt_a, pred_a)
        iou_q = mask_iou(gt_q, pred_q)

    losses = {
        "mask": cfg.w_mask * mask_loss,
        "pos": cfg.w_pos * pos_loss,
        "neg": cfg.w_neg * neg_loss,
    }
    total = losses["mask"] + losses["pos"] + losses["neg"]
    return LossOutputs(total, losses, iou_a, iou_q, pred_a, pred_q)
