"""Operations and bytes of the EVA02 vision tower's 2D rotary (kernel R1)
on the packed q|k|v of one block, from its shapes; the same whatever
implements the work."""
from __future__ import annotations

from typing import Tuple


def rope(images: int, tokens: int, width: int, heads: int,
         itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of rotating q and k of the patch rows (every token
    but the class token) of ``images`` packed [tokens, 3 * width] rows in
    place: q and k of those rows read once and written once in the storage
    type, and the f32 cos and sin tables [tokens - 1, head dim] read once;
    two products and a sum an element (f32, off the tensor cores)."""
    elems = images * (tokens - 1) * 2 * width
    nbytes = 2.0 * itemsize * elems + 2.0 * 4 * (tokens - 1) * (width // heads)
    return 3.0 * elems, nbytes
