"""Coordinate-frame transforms between featmap and original resolutions.

Counterpart of ``oryon_tpu/geometry/coords.py``: (y, x) pairs in the
trailing dimension, scaled by target/source per axis.  ``source`` and
``target`` may be (H, W) pairs or tensors [..., 2] that broadcast against
the coordinates' leading dimensions.
"""
from __future__ import annotations

import torch


def _hw(size, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(size, dtype=torch.float32, device=like.device)


def scale_coords(coords: torch.Tensor, source, target) -> torch.Tensor:
    """Rescale (..., 2k) yx-coordinates from ``source`` to ``target``: even
    channels by the H ratio, odd channels by the W ratio."""
    coords = coords.float()
    k = coords.shape[-1] // 2
    ratio = _hw(target, coords) / _hw(source, coords)
    return coords * ratio.tile(k)


def crop_coords(coords: torch.Tensor, origin) -> torch.Tensor:
    """Subtract a crop origin (y0, x0) from (..., 2) yx coords."""
    coords = coords.float()
    return coords - _hw(origin, coords)


def decrop_coords(coords: torch.Tensor, origin) -> torch.Tensor:
    """Add a crop origin (y0, x0) back to (..., 2) yx coords."""
    coords = coords.float()
    return coords + _hw(origin, coords)


def valid_coords(coords: torch.Tensor, bounds) -> torch.Tensor:
    """Boolean mask of (..., 2) yx coords inside [0, H) x [0, W)."""
    b = _hw(bounds, coords).to(coords.dtype)
    ok_y = (coords[..., 0] >= 0) & (coords[..., 0] < b[..., 0])
    ok_x = (coords[..., 1] >= 0) & (coords[..., 1] < b[..., 1])
    return ok_y & ok_x
