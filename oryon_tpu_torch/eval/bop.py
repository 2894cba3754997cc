"""BOP pose-error functions: MSSD, MSPD, VSD, batched over poses.

Counterpart of ``oryon_tpu/eval/bop.py`` (the BOP toolkit's ``pose_error``
and ``visibility`` formulas): MSSD and MSPD over a fixed [S, 3, 4] symmetry
set (identity first), VSD from rendered depths (``eval/renderer.py``), and
the three BOP recalls.  Poses and points are f32; every rigid transform and
projection is an explicit multiply-add, so no TF32 product reaches a score.
Leading dimensions of the poses (and of K, the depths and the origin) are
batch dimensions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# the recall thresholds, computed as the JAX package computes them
# (jnp.arange in f32): fractions of the diameter / of the VSD error, and px
_FRACTIONS = np.arange(0.05, 0.51, 0.05, dtype=np.float32)
_PIXELS = np.arange(5.0, 51.0, 5.0, dtype=np.float32)


def _apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3], t [..., 3], pts [N, 3] -> [..., N, 3]."""
    return (pts[:, None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]


def _sym_poses(R_gt: torch.Tensor, t_gt: torch.Tensor, syms: torch.Tensor):
    """The GT pose composed with each symmetry: (R [..., S, 3, 3], t [..., S, 3])."""
    Rg = R_gt[..., None, :, :]                                   # [..., 1, 3, 3]
    R = (Rg[..., :, :, None] * syms[:, None, :3, :3]).sum(-2)     # [..., S, 3, 3]
    t = (Rg * syms[:, None, :3, 3]).sum(-1) + t_gt[..., None, :]  # [..., S, 3]
    return R, t


def mssd(R_est, t_est, R_gt, t_gt, pts: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """Maximum symmetry-aware surface distance: min over symmetries of the
    max over points of |T_est p - T_gt_sym p|.  R [..., 3, 3], t [..., 3],
    pts [N, 3], syms [S, 3, 4] -> [...]."""
    p_est = _apply(R_est, t_est, pts)                            # [..., N, 3]
    Rs, ts = _sym_poses(R_gt, t_gt, syms)
    p_sym = _apply(Rs, ts, pts)                                  # [..., S, N, 3]
    d = torch.linalg.norm(p_est[..., None, :, :] - p_sym, dim=-1)
    return d.amax(-1).amin(-1)


def _project(R, t, pts, K):
    cam = _apply(R, t, pts)                                      # [..., N, 3]
    im = (cam[..., None, :] * K[..., None, :, :]).sum(-1)
    return im[..., :2] / im[..., 2:3]


def mspd(R_est, t_est, R_gt, t_gt, K, pts: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """Maximum symmetry-aware projection distance (pixels); K [..., 3, 3]."""
    proj_est = _project(R_est, t_est, pts, K)                    # [..., N, 2]
    Rs, ts = _sym_poses(R_gt, t_gt, syms)
    proj_sym = _project(Rs, ts, pts, K[..., None, :, :])         # [..., S, N, 2]
    d = torch.linalg.norm(proj_est[..., None, :, :] - proj_sym, dim=-1)
    return d.amax(-1).amin(-1)


def depth_to_dist(depth: torch.Tensor, K: torch.Tensor,
                  origin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth image [..., H, W] -> distance-from-camera image; zero depth
    stays zero.  ``origin`` ([..., 2] int (y0, x0)) offsets the pixel grid
    of a window cut out of a full frame."""
    H, W = depth.shape[-2:]
    dev = depth.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    if origin is not None:
        xs = xs + origin[..., 1, None].float()                   # [..., W]
        ys = ys + origin[..., 0, None].float()                   # [..., H]
    xs, ys = xs[..., None, :], ys[..., :, None]
    X = (xs - K[..., 0, 2, None, None]) / K[..., 0, 0, None, None] * depth
    Y = (ys - K[..., 1, 2, None, None]) / K[..., 1, 1, None, None] * depth
    return torch.sqrt(X * X + Y * Y + depth.float() ** 2)


def visib_mask_gt(d_test, d_gt, delta: float):
    """bop19 visibility of the model surface in the GT pose: in front of (or
    within delta of) the measured surface, or where the sensor has no depth."""
    return ((d_gt - d_test <= delta) | (d_test == 0)) & (d_gt > 0)


def visib_mask_est(d_test, d_est, visib_gt, delta: float):
    """bop19 visibility in the estimated pose."""
    v = ((d_est - d_test <= delta) | (d_test == 0)) & (d_est > 0)
    return v | (visib_gt & (d_est > 0))


def vsd_errors(depth_est, depth_gt, depth_test, K, delta: float, taus: Sequence[float],
               diameter, origin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Visible surface discrepancy, one error per tau ('step' cost,
    normalised by the diameter): depths [..., H, W] (mm; rendered est / GT
    and the measured scene), diameter a number or [...] -> [..., T].

    A window is exact when it holds both renders' nonzero pixels: both
    visibility masks are zero wherever their render is zero, and ``origin``
    keeps the pixel rays of ``depth_to_dist`` in absolute coordinates."""
    dist_test = depth_to_dist(depth_test, K, origin)
    dist_gt = depth_to_dist(depth_gt, K, origin)
    dist_est = depth_to_dist(depth_est, K, origin)
    visib_gt = visib_mask_gt(dist_test, dist_gt, delta)
    visib_est = visib_mask_est(dist_test, dist_est, visib_gt, delta)
    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    union_count = union.sum((-2, -1))
    comp_count = union_count - inter.sum((-2, -1))
    diam = torch.as_tensor(diameter, dtype=torch.float32, device=depth_gt.device)
    dists = (dist_gt - dist_est).abs() / diam[..., None, None]
    taus_t = torch.tensor([float(t) for t in taus], dtype=torch.float32,
                          device=depth_gt.device)
    costs = (dists[..., None, :, :] >= taus_t[:, None, None]) & inter[..., None, :, :]
    errs = ((costs.sum((-2, -1)) + comp_count[..., None])
            / torch.clamp(union_count, min=1)[..., None])
    return torch.where(union_count[..., None] == 0, torch.ones_like(errs), errs)


def _mean(hits: torch.Tensor, dims) -> torch.Tensor:
    """Mean of 0/1 values as XLA takes it: the f32 sum times f32(1 / n)
    (torch's sum / n can differ in the last bit)."""
    n = int(np.prod([hits.shape[d] for d in dims]))
    inv = torch.tensor(1.0 / n, dtype=torch.float32, device=hits.device)
    return hits.float().sum(dims) * inv


def mssd_recall(err: torch.Tensor, diameter) -> torch.Tensor:
    """Mean recall over the BOP thresholds 0.05..0.5 x diameter."""
    d = torch.as_tensor(diameter, dtype=torch.float32, device=err.device)
    th = torch.as_tensor(_FRACTIONS, device=err.device) * d[..., None]
    return _mean(err[..., None] < th, (-1,))


def mspd_recall(err: torch.Tensor) -> torch.Tensor:
    """Mean recall over 5..50 px."""
    return _mean(err[..., None] < torch.as_tensor(_PIXELS, device=err.device), (-1,))


def vsd_recall(errs: torch.Tensor) -> torch.Tensor:
    """Mean recall of per-tau VSD errors [..., T] over thresholds 0.05..0.5."""
    rec = torch.as_tensor(_FRACTIONS, device=errs.device)
    return _mean(errs[..., :, None] < rec, (-2, -1))
