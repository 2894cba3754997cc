"""The port's native host runtime: mask codecs and uint8 resizes in C++.

``oryon_tpu_torch/native/oryon_native.cpp`` is built on first use with the
host C++ compiler (``$CXX``, default ``g++``) into ``build/oryon_tpu_torch/``
at the root of the checkout, named by a hash of the source, the flags and
the compiler's ``--version``, so an edited source or another compiler is
rebuilt and an unchanged one is reused.  The library is loaded with
``ctypes.CDLL``, so every call releases the GIL (the loader's worker thread
runs these while the main thread dispatches).  A failed build raises with
the compiler's command and output: nothing falls back to numpy.

Entries, with the semantics of ``oryon_tpu/utils/native.py``:
  * ``rle_encode`` / ``rle_decode``: run-length codes of binary masks, the
    first run counting zeros;
  * ``resize_bilinear_u8``: half-pixel bilinear resize of [H, W] or
    [H, W, C] uint8 in f32, rounded half up;
  * ``resize_nearest_u8``: nearest resize, index ``floor(i * in / out)``;
    the C entry is single-channel, so 3-D input takes the plain version.

The ``*_plain`` functions are the numpy versions the library is held
against; the data path calls them only where the library has no entry
(bilinear resizes of other dtypes, nearest resizes of 3-D or non-uint8
arrays), as the JAX package's numpy code does.
"""
from __future__ import annotations

import ctypes
import os
import shlex
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from oryon_tpu_torch.utils.shlib import BUILD_DIR, build_and_load

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "native", "oryon_native.cpp")
# no -march=native and no fast math: a fused multiply-add would move the
# f32 blend of the bilinear resize off the reference library's bytes
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {   # name -> (restype, argtypes)
    "rle_encode": (ctypes.c_int, [_P, _I64, _P, _I]),
    "rle_decode": (ctypes.c_int64, [_P, _I, _P, _I64]),
    "resize_bilinear_u8": (None, [_P, _I, _I, _I, _P, _I, _I]),
    "resize_nearest_u8": (None, [_P, _I, _I, _P, _I, _I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def _run(cmd) -> str:
    """stdout of ``cmd``; raises with the command and its output."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build: {' '.join(cmd)} failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native build: {' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout}{res.stderr}")
    return res.stdout


def library() -> ctypes.CDLL:
    """The loaded library, built first if no build of this source, flags
    and compiler is there (``utils/shlib.py``)."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            with open(SOURCE, "rb") as f:
                key = (f.read() + " ".join(CXX_FLAGS).encode()
                       + _run([*cxx, "--version"]).encode())
            _lib = build_and_load(BUILD_DIR, "liboryon_native", key,
                                  lambda tmp: _run([*cxx, *CXX_FLAGS, "-o", tmp, SOURCE]),
                                  SIGNATURES)[0]
        return _lib


def _check_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> None:
    if img.ndim not in (2, 3) or min(img.shape) == 0 or min(out_hw) <= 0:
        raise ValueError(f"resize of an image of shape {img.shape} to {tuple(out_hw)}")


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Binary mask -> int32 run lengths; the first run counts zeros."""
    flat = np.ascontiguousarray(mask.reshape(-1).astype(np.uint8))
    runs = np.empty(flat.size + 1, np.int32)    # at most one run a value + 1
    n = library().rle_encode(flat.ctypes.data, flat.size, runs.ctypes.data, runs.size)
    return runs[:n].copy()


def rle_decode(runs: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Run lengths (``rle_encode``) -> uint8 mask of ``shape``."""
    runs = np.ascontiguousarray(np.asarray(runs).astype(np.int32))
    if (runs < 0).any():
        raise ValueError("negative run length")
    n = int(np.prod(shape))
    out = np.zeros(n, np.uint8)
    library().rle_decode(runs.ctypes.data, len(runs), out.ctypes.data, n)
    return out.reshape(shape)


def resize_bilinear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W(, C)] uint8 half-pixel bilinear resize (f32, rounded half up)."""
    _check_resize(img, out_hw)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    oh, ow = out_hw
    src = np.ascontiguousarray(img.reshape(h, w, c).astype(np.uint8))
    dst = np.empty((oh, ow, c), np.uint8)
    library().resize_bilinear_u8(src.ctypes.data, h, w, c, dst.ctypes.data, oh, ow)
    return dst if img.ndim == 3 else dst[..., 0]


def resize_nearest_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W] uint8 nearest resize; [H, W, C] takes the plain version."""
    if img.ndim != 2:
        return resize_nearest_plain(img, out_hw)
    _check_resize(img, out_hw)
    h, w = img.shape
    oh, ow = out_hw
    src = np.ascontiguousarray(img.astype(np.uint8))
    dst = np.empty((oh, ow), np.uint8)
    library().resize_nearest_u8(src.ctypes.data, h, w, dst.ctypes.data, oh, ow)
    return dst


def rle_encode_plain(mask: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(mask.reshape(-1)).astype(bool)
    changes = np.nonzero(np.diff(b.astype(np.int8)))[0] + 1
    bounds = np.concatenate([[0], changes, [b.size]])
    runs = np.diff(bounds).astype(np.int32)
    if b.size and b[0]:
        runs = np.concatenate([[np.int32(0)], runs])
    return runs


def rle_decode_plain(runs: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    out = np.zeros(int(np.prod(shape)), np.uint8)
    pos, val = 0, 0
    for r in np.asarray(runs, np.int64):
        out[pos: pos + r] = val
        pos += int(r)
        val = 1 - val
    return out.reshape(shape)


def resize_bilinear_plain(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """numpy, any dtype: weights in f64; integer input is rounded to nearest
    (half to even, up to 1 LSB off the library) and cast back."""
    H, W = img.shape[:2]
    OH, OW = out_hw
    ys = (np.arange(OH) + 0.5) * H / OH - 0.5
    xs = (np.arange(OW) + 0.5) * W / OW - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    if np.issubdtype(img.dtype, np.integer):
        # round, don't truncate (the f32 resize-then-quantise wire format)
        out = np.rint(out)
    return out.astype(img.dtype)


def resize_nearest_plain(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    H, W = img.shape[:2]
    OH, OW = out_hw
    ys = np.floor(np.arange(OH) * H / OH).astype(int)
    xs = np.floor(np.arange(OW) * W / OW).astype(int)
    return img[np.ix_(ys, xs)]
