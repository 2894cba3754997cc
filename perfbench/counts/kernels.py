"""Operations and bytes that a kernel's work needs, from its shapes, and the
least time the card could take for it: the larger of operations over the
peak of their type and bytes over the memory bandwidth.  Each input byte is
counted read once and each output byte written once.  The same whatever
implements the work."""
from __future__ import annotations

from typing import Tuple

from perfbench.counts import peaks


def bound_s(ops: float, nbytes: float, rate: float = peaks.BF16_FLOPS) -> float:
    return max(ops / rate, nbytes / peaks.HBM_BYTES_PER_S)


def k1(images: int, tokens: int, width: int, heads: int) -> Tuple[float, float]:
    """K1, fused multi-head attention over a packed bf16 q|k|v [images,
    tokens, 3 * width]: (operations, bytes).  QK^T and PV, two operations a
    multiply-add; qkv read, the [images, tokens, width] bf16 output and the
    f32 key mask of ``tokens`` entries."""
    hd = width // heads
    ops = 4.0 * images * heads * tokens * tokens * hd
    nbytes = 2.0 * images * tokens * 3 * width + 2.0 * images * tokens * width + 4.0 * tokens
    return ops, nbytes


def k2(pairs_work: float, pairs: int, sources: int, targets: int, dim: int) -> Tuple[float, float]:
    """K2, masked cosine argmin: (operations, bytes).  ``pairs_work`` is the
    sum over pairs of (valid sources x targets kept by the mask), the
    products these inputs need; bytes: f32 sources and targets and the
    exclusion flags read, f32 minima and int32 indices written."""
    ops = 2.0 * pairs_work * dim
    nbytes = pairs * (4.0 * sources * dim + 4.0 * targets * dim + targets + 8.0 * sources)
    return ops, nbytes
