"""Debug visualization: masks, correspondences, poses, featmap PCA.

The port's own copy of ``oryon_tpu/utils/viz.py`` (numpy arrays in,
matplotlib imported when a figure is drawn): the tracked-pair renders of
the evaluation loop (``cfg.viz_valid``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _ensure_dir(path: str) -> None:
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def pred_mask(rgb_a, rgb_q, gt_mask_a, gt_mask_q, pred_mask_a, pred_mask_q,
              out_path: str) -> None:
    """2x3 panel: rgb, GT mask overlay, predicted mask overlay per view."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(out_path)
    fig, ax = plt.subplots(2, 3, figsize=(12, 7))
    for r, (rgb, gt, pr) in enumerate([(rgb_a, gt_mask_a, pred_mask_a),
                                       (rgb_q, gt_mask_q, pred_mask_q)]):
        ax[r, 0].imshow(np.clip(rgb, 0, 1))
        ax[r, 0].set_title("rgb")
        ax[r, 1].imshow(np.clip(rgb, 0, 1))
        ax[r, 1].imshow(gt, alpha=0.5, cmap="spring")
        ax[r, 1].set_title("gt mask")
        ax[r, 2].imshow(np.clip(rgb, 0, 1))
        ax[r, 2].imshow(pr, alpha=0.5, cmap="cool")
        ax[r, 2].set_title("pred mask")
    for a in ax.ravel():
        a.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=90)
    plt.close(fig)


def corr_set(rgb_a, rgb_q, corrs: np.ndarray,
             valid: Optional[np.ndarray] = None,
             out_path: str = "corrs.png", max_draw: int = 60) -> None:
    """Side-by-side images with correspondence lines (y1,x1,y2,x2 rows)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(out_path)
    H, W = rgb_a.shape[:2]
    canvas = np.concatenate([np.clip(rgb_a, 0, 1), np.clip(rgb_q, 0, 1)], axis=1)
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(canvas)
    rows = np.asarray(corrs)
    if valid is not None:
        rows = rows[np.asarray(valid).astype(bool)]
    step = max(len(rows) // max_draw, 1)
    for y1, x1, y2, x2 in rows[::step]:
        ax.plot([x1, x2 + W], [y1, y2], lw=0.6)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=90)
    plt.close(fig)


def pred_pose(rgb, K: np.ndarray, gt_pose: np.ndarray, pred_pose_: np.ndarray,
              obj_pts: np.ndarray, out_path: str, n_pts: int = 400) -> None:
    """Project the model under GT (green) and predicted (red) poses."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(out_path)

    def proj(T):
        cam = obj_pts[:n_pts] @ T[:3, :3].T + T[:3, 3]
        im = cam @ np.asarray(K).T
        return im[:, :2] / np.maximum(im[:, 2:3], 1e-6)

    fig, ax = plt.subplots(figsize=(7, 6))
    ax.imshow(np.clip(rgb, 0, 1))
    g = proj(np.asarray(gt_pose))
    p = proj(np.asarray(pred_pose_))
    ax.scatter(g[:, 0], g[:, 1], s=1, c="lime", label="gt")
    ax.scatter(p[:, 0], p[:, 1], s=1, c="red", label="pred")
    ax.legend()
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=90)
    plt.close(fig)


def featmap_to_rgb(featmap: np.ndarray) -> np.ndarray:
    """PCA the channel dim of an [H, W, D] feature map to 3 channels in
    [0, 1] (reference utils/viz.py:438)."""
    H, W, D = featmap.shape
    flat = featmap.reshape(-1, D).astype(np.float64)
    flat = flat - flat.mean(0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    rgb = flat @ vt[:3].T
    lo, hi = rgb.min(0), rgb.max(0)
    rgb = (rgb - lo) / np.maximum(hi - lo, 1e-9)
    return rgb.reshape(H, W, 3).astype(np.float32)
