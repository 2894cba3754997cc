"""Separable image resizing as two small matmuls with exact control.

Counterpart of ``oryon_tpu/ops/resize.py``.  ``F.interpolate`` is not used:
its bicubic border handling differs from the Keys kernel (a=-0.75) with
clamped taps that the reference pipeline and the JAX package use.  The
weight matrices are built once per size in numpy and applied as
``W_h @ x @ W_w^T`` in f32 (full f32: callers keep TF32 off).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
        np.where(at < 2.0, a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a, 0.0),
    )


@lru_cache(maxsize=256)
def resize_matrix(
    in_size: int,
    out_size: int,
    method: str = "linear",
    align_corners: bool = False,
) -> np.ndarray:
    """[out_size, in_size] float32 interpolation weights (rows sum to 1)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)

    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5

    W = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "nearest":
        # torch 'nearest': floor(i * in/out)
        idx = np.floor(np.arange(out_size) * in_size / out_size).astype(int)
        W[np.arange(out_size), np.clip(idx, 0, in_size - 1)] = 1.0
    elif method == "linear":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for off, w in ((0, 1 - frac), (1, frac)):
            idx = np.clip(i0 + off, 0, in_size - 1)
            np.add.at(W, (np.arange(out_size), idx), w)
    elif method == "cubic":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for off in (-1, 0, 1, 2):
            w = _cubic_kernel(off - frac)
            idx = np.clip(i0 + off, 0, in_size - 1)
            np.add.at(W, (np.arange(out_size), idx), w)
    else:
        raise ValueError(method)
    return W.astype(np.float32)


@lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, method: str, align_corners: bool,
            device: torch.device) -> torch.Tensor:
    # kept for later calls: made outside inference mode, so that a matrix
    # first asked for while serving can still enter a graph that autograd tracks
    with torch.inference_mode(False):
        return torch.from_numpy(
            resize_matrix(in_size, out_size, method, align_corners)).to(device)


def resize2d(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "linear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize (..., H, W, C) images to out_hw with the chosen kernel."""
    H, W = x.shape[-3], x.shape[-2]
    OH, OW = out_hw
    Wh = _matrix(H, OH, method, align_corners, x.device)
    Ww = _matrix(W, OW, method, align_corners, x.device)
    xf = x.float()
    y = torch.einsum("oh,...hwc->...owc", Wh, xf)
    y = torch.einsum("pw,...owc->...opc", Ww, y)
    return y.to(x.dtype)


def resize_mask_nearest(mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of a (..., H, W) mask (F.interpolate
    mode='nearest' semantics)."""
    y = resize2d(mask[..., None].float(), out_hw, "nearest")
    return y[..., 0].to(mask.dtype)
