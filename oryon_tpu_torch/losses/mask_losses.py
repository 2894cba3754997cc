"""Segmentation losses over mask logits.

Counterpart of ``oryon_tpu/losses/mask_losses.py``, with its formulas:

* dice: the 2-class softmax form with smooth 1, p = 2 and 0.5 / 0.5 class
  weights; softmax([x, -x]) is written as sigmoid(2x), as there;
* focal: binary focal loss, alpha 0.25, gamma 2;
* lovasz: the Lovász hinge per image, by a stable sort and a cumulative sum;
* bce: sigmoid cross entropy.

Each takes logits (..., H, W) and binary targets (..., H, W) and returns a
scalar, reduced over every element.
"""
from __future__ import annotations

import torch


def bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    t = target.float()
    x = logits.float()
    loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.mean(loss)


def _binary_dice(p: torch.Tensor, t: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Per-image binary dice on probabilities, mean over the batch."""
    B = p.shape[0]
    p2 = p.reshape(B, -1)
    t2 = t.reshape(B, -1)
    num = torch.sum(p2 * t2, dim=1) + smooth
    den = torch.sum(p2 ** 2 + t2 ** 2, dim=1) + smooth
    return torch.mean(1.0 - num / den)


def dice_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2-class softmax dice, the default mask loss."""
    x = logits.float()
    t = target.float()
    p_fg = torch.sigmoid(2.0 * x)       # softmax([x, -x]) foreground prob
    p_bg = 1.0 - p_fg
    d_fg = _binary_dice(p_fg, t)
    d_bg = _binary_dice(p_bg, 1.0 - t)
    return (0.5 * d_fg + 0.5 * d_bg) / 2.0


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    x = logits.float()
    t = target.float()
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    return torch.mean(loss)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Per-row gradient of the Lovász extension of the Jaccard loss, [B, n]."""
    gts = torch.sum(gt_sorted, dim=-1, keepdim=True)
    inter = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jac = 1.0 - inter / union
    return torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=-1)


def lovasz_hinge(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image Lovász hinge averaged over the batch."""
    B = logits.shape[0]
    x = logits.float().reshape(B, -1)
    t = target.float().reshape(B, -1)
    errors = 1.0 - x * (2.0 * t - 1.0)
    order = torch.argsort(-errors, dim=-1, stable=True)
    errors_sorted = torch.gather(errors, 1, order)
    grad = _lovasz_grad(torch.gather(t, 1, order))
    return torch.mean(torch.sum(torch.relu(errors_sorted) * grad, dim=-1))


MASK_LOSSES = {
    "dice": dice_loss,
    "cross_entropy": bce_loss,
    "focal": focal_loss,
    "lovasz": lovasz_hinge,
}
