"""Host-side mask codecs and uint8 resizes, in numpy.

Counterpart of ``oryon_tpu/utils/native.py`` without its ctypes library:
these are the numpy versions that the JAX package falls back to when the
library is absent.  Run-length coding of binary masks (the first run counts
zeros) and the uint8 bilinear / nearest resizes of the data path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Binary mask -> int32 run lengths; the first run counts zeros."""
    b = np.ascontiguousarray(mask.reshape(-1)).astype(bool)
    changes = np.nonzero(np.diff(b.astype(np.int8)))[0] + 1
    bounds = np.concatenate([[0], changes, [b.size]])
    runs = np.diff(bounds).astype(np.int32)
    if b.size and b[0]:
        runs = np.concatenate([[np.int32(0)], runs])
    return runs


def rle_decode(runs: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Run lengths (``rle_encode``) -> uint8 mask of ``shape``."""
    out = np.zeros(int(np.prod(shape)), np.uint8)
    pos, val = 0, 0
    for r in np.asarray(runs, np.int64):
        out[pos: pos + r] = val
        pos += int(r)
        val = 1 - val
    return out.reshape(shape)


def resize_bilinear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W(, C)] uint8 bilinear resize (half-pixel), rounded to nearest."""
    from oryon_tpu_torch.data.augment import resize_bilinear

    out = resize_bilinear(img.astype(np.float32), out_hw)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def resize_nearest_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    from oryon_tpu_torch.data.augment import resize_nearest

    return resize_nearest(img.astype(np.uint8), out_hw)
