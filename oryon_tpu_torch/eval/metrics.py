"""Pose and segmentation metrics, batched over leading dimensions.

Counterpart of ``oryon_tpu/eval/metrics.py``: mask IoU and feature-match
recall (computed by the serving pipeline on the device), rotation and
translation errors, ADD and ADD-S, entropy, and the host-side
optimal-assignment pixel distance.  Everything computes in the dtype of
its inputs (f32 on the serving path, with full-precision matmuls).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from oryon_tpu_torch.geometry.pcd import sq_dist_matrix, transform_pcd_h, unit


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """IoU between [..., H, W] binary masks -> [...]."""
    m1 = mask1.bool().flatten(-2)
    m2 = mask2.bool().flatten(-2)
    inter = torch.sum(m1 & m2, dim=-1)
    union = torch.sum(m1 | m2, dim=-1)
    return inter / torch.clamp(union, min=1)


def fmr(feats1: torch.Tensor, feats2: torch.Tensor, dist_th: float,
        inlier_th: float, w: Optional[torch.Tensor] = None):
    """Feature-match recall over (..., N, D) matched feature sets, and the
    per-set feature inlier ratio behind it.  ``w`` (..., N): optional 0/1
    validity weights for padded correspondence buffers."""
    cos = torch.sum(unit(feats1) * unit(feats2), dim=-1)
    inl = (0.5 * (1.0 - cos) < dist_th).float()
    if w is None:
        ratio = inl.mean(-1)
    else:
        w = w.float()
        ratio = torch.sum(inl * w, dim=-1) / torch.clamp(w.sum(-1), min=1.0)
    return (ratio > inlier_th).float(), ratio


def rotation_translation_errors(pose1: torch.Tensor, pose2: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angle difference (degrees) and translation difference (centimetres)
    of poses (..., 4, 4) with translations in metres, in the poses' dtype
    (the arccos resolves about 0.02 degree in f32; pass f64 poses to score
    a finer difference).  The rotations are normalised to determinant 1
    first; a NaN angle reads 180."""
    R1 = pose1[..., :3, :3]
    R2 = pose2[..., :3, :3]
    R1 = R1 / _cbrt(torch.linalg.det(R1))[..., None, None]
    R2 = R2 / _cbrt(torch.linalg.det(R2))[..., None, None]
    tr = torch.einsum("...ij,...ij->...", R1, R2)     # trace(R1 R2^T)
    arg = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-12, 1.0 - 1e-12)
    theta = torch.rad2deg(torch.arccos(arg))
    theta = torch.where(torch.isnan(theta), torch.full_like(theta, 180.0), theta)
    shift = torch.linalg.norm(pose1[..., :3, 3] - pose2[..., :3, 3], dim=-1) * 100.0
    return theta, shift


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _weighted_mean(d: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return d.mean(-1)
    return torch.sum(d * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)


def compute_add(pts: torch.Tensor, pred_pose: torch.Tensor, gt_pose: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ADD: mean distance of the model points (..., N, 3) under the two
    poses (..., 4, 4).  ``w`` (..., N): optional 0/1 point weights, so that a
    padded point buffer scores like an exact-size one."""
    d = torch.linalg.norm(transform_pcd_h(pts, pred_pose) - transform_pcd_h(pts, gt_pose),
                          dim=-1)
    return _weighted_mean(d, w)


def compute_adds(pts: torch.Tensor, pred_pose: torch.Tensor, gt_pose: torch.Tensor,
                 w: Optional[torch.Tensor] = None, chunk: int = 4096) -> torch.Tensor:
    """ADD-S: mean distance from each predicted-pose point to its nearest
    gt-pose point, by exact brute force.  ``w``: optional 0/1 point weights;
    padding must duplicate real points, so that the pool of targets is
    unchanged, and the mean over sources is weighted.  The sources are
    walked ``chunk`` at a time, so a model of N points never builds an
    N x N matrix."""
    p = transform_pcd_h(pts, pred_pose)
    g = transform_pcd_h(pts, gt_pose)
    d2 = torch.cat([sq_dist_matrix(p[..., i:i + chunk, :], g).amin(dim=-1)
                    for i in range(0, p.shape[-2], chunk)], dim=-1)
    return _weighted_mean(torch.sqrt(d2 + 1e-12), w)


def entropy(probs: torch.Tensor, axis: int, norm: bool = False) -> torch.Tensor:
    """Entropy along an axis, optionally normalised to [0, 1]."""
    h = -torch.sum(probs * torch.log(probs + 1e-12), dim=axis)
    return h / math.log(probs.shape[axis]) if norm else h


def pixel_match_loss(gt_matches, pred_matches) -> np.ndarray:
    """Mean optimal-assignment pixel distance between predicted and ground
    truth match sets [B, N, 4] (y1, x1, y2, x2), per pair; on the host, by
    scipy's Hungarian solver.  An empty set scores 0."""
    from scipy.optimize import linear_sum_assignment

    gt = np.asarray(gt_matches, np.float64)
    pr = np.asarray(pred_matches, np.float64)
    err = np.zeros(pr.shape[0])
    for i, (g, p) in enumerate(zip(gt, pr)):
        if g.shape[0] == 0 or p.shape[0] == 0:
            continue
        d1 = np.linalg.norm(p[:, None, :2] - g[None, :, :2], axis=-1)
        d2 = np.linalg.norm(p[:, None, 2:] - g[None, :, 2:], axis=-1)
        dists = (d1 + d2) / 2.0
        r, c = linear_sum_assignment(dists)
        err[i] = dists[r, c].mean()
    return err
