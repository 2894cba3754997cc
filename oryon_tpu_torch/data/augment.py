"""Pair-consistent host-side augmentations with correspondence remapping.

The port's own copy of ``oryon_tpu/data/augment.py`` (numpy, host only):
  * color jitter / brightness (independent per view, prob 0.5 each);
  * horizontal / vertical flips that also remap the (y1,x1,y2,x2)
    correspondence endpoints;
  * final bilinear/nearest resize to the model's input size with the
    correspondences rescaled.

``resize_only`` is the evaluation path; ``augment_pair`` is kept for
training.  As in the JAX package, uint8 bilinear resizes (the training views
under the uint8 RGB cache) and 2-D uint8 nearest resizes (every mask) run in
the port's C++ library (``utils/native.py``); the rest run its numpy plain
versions ``resize_bilinear_plain`` / ``resize_nearest_plain``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from oryon_tpu_torch.utils import native


@dataclasses.dataclass
class AugmentConfig:
    jitter: bool = True
    bright: bool = True
    hflip: bool = True
    vflip: bool = True
    prob: float = 0.5
    out_size: Tuple[int, int] = (224, 224)


def _adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def _adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # torchvision uses the mean of the grayscale image
    gray = img @ np.array([0.299, 0.587, 0.114], img.dtype)
    mean = gray.mean()
    return np.clip((img - mean) * factor + mean, 0.0, 1.0)


def _adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ np.array([0.299, 0.587, 0.114], img.dtype))[..., None]
    return np.clip((img - gray) * factor + gray, 0.0, 1.0)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Approximate hue rotation via the YIQ linear transform."""
    t = 2 * np.pi * shift
    cos, sin = np.cos(t), np.sin(t)
    T_yiq = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.322],
                      [0.211, -0.523, 0.312]])
    R = np.array([[1, 0, 0], [0, cos, -sin], [0, sin, cos]])
    M = np.linalg.inv(T_yiq) @ R @ T_yiq
    return np.clip(img @ M.T, 0.0, 1.0)


def color_jitter(rs: np.random.RandomState, img: np.ndarray,
                 brightness=0.125, contrast=0.5, saturation=0.5, hue=0.05):
    """torchvision ColorJitter semantics: random order, uniform factors."""
    ops = []
    if brightness:
        ops.append(("b", rs.uniform(1 - brightness, 1 + brightness)))
    if contrast:
        ops.append(("c", rs.uniform(1 - contrast, 1 + contrast)))
    if saturation:
        ops.append(("s", rs.uniform(1 - saturation, 1 + saturation)))
    if hue:
        ops.append(("h", rs.uniform(-hue, hue)))
    rs.shuffle(ops)
    for kind, val in ops:
        if kind == "b":
            img = _adjust_brightness(img, val)
        elif kind == "c":
            img = _adjust_contrast(img, val)
        elif kind == "s":
            img = _adjust_saturation(img, val)
        else:
            img = _adjust_hue(img, val)
    return img


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Half-pixel bilinear resize of [H, W(, C)] arrays; uint8 through the
    C++ library (f32, rounded half up)."""
    if tuple(img.shape[:2]) == tuple(out_hw):
        # identity: at half-pixel alignment every weight is 0/1 and the
        # gather reproduces the input
        return img
    if img.dtype == np.uint8:
        return native.resize_bilinear_u8(img, out_hw)
    return native.resize_bilinear_plain(img, out_hw)


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize (index ``floor(i * in / out)``); 2-D uint8 (masks)
    through the C++ library."""
    if img.dtype == np.uint8 and img.ndim == 2:
        return native.resize_nearest_u8(img, out_hw)
    return native.resize_nearest_plain(img, out_hw)


def augment_pair(
    rs: np.random.RandomState,
    item_a: Dict[str, np.ndarray],
    item_q: Dict[str, np.ndarray],
    corrs: np.ndarray,          # [N, 4] float (y1, x1, y2, x2)
    cfg: AugmentConfig,
    skip_depth: bool = False,
):
    """Applies the augmentation stack; items carry rgb [H,W,3] in
    [0,1], mask [H,W], depth [H,W].  ``skip_depth`` leaves depth untouched
    (a training batch carries none)."""
    corrs = corrs.astype(np.float64).copy()
    geom_keys = ("rgb", "mask") if skip_depth else ("rgb", "mask", "depth")

    for side, item, sl in (("a", item_a, slice(0, 2)), ("q", item_q, slice(2, 4))):
        if cfg.jitter and rs.rand() < cfg.prob:
            item["rgb"] = color_jitter(rs, item["rgb"])
        if cfg.bright and rs.rand() < cfg.prob:
            item["rgb"] = color_jitter(rs, item["rgb"], brightness=0.25,
                                       contrast=0, saturation=0, hue=0)
        H, W = item["mask"].shape
        if cfg.hflip and rs.rand() < cfg.prob:
            for k in geom_keys:
                item[k] = item[k][:, ::-1].copy()
            corrs[:, sl][:, 1] = W - corrs[:, sl][:, 1] - 1
        if cfg.vflip and rs.rand() < cfg.prob:
            for k in geom_keys:
                item[k] = item[k][::-1].copy()
            corrs[:, sl][:, 0] = H - corrs[:, sl][:, 0] - 1

    for item, sl in ((item_a, slice(0, 2)), (item_q, slice(2, 4))):
        H, W = item["mask"].shape
        item["rgb"] = resize_bilinear(item["rgb"], cfg.out_size)
        item["mask"] = resize_nearest(item["mask"], cfg.out_size)
        if not skip_depth:
            item["depth"] = resize_bilinear(item["depth"].astype(np.float32),
                                            cfg.out_size)
        corrs[:, sl][:, 0] *= cfg.out_size[0] / H
        corrs[:, sl][:, 1] *= cfg.out_size[1] / W

    return item_a, item_q, corrs


def resize_only(item_a, item_q, corrs, out_size, skip_depth: bool = False):
    """Eval-time preprocessing: resize both views and rescale the
    correspondences, nothing random."""
    cfg = AugmentConfig(jitter=False, bright=False, hflip=False, vflip=False,
                        out_size=out_size)
    rs = np.random.RandomState(0)
    return augment_pair(rs, item_a, item_q, corrs, cfg, skip_depth=skip_depth)
