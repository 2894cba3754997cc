"""In-RAM decoded-item cache around any dataset reader.

The port's own copy of ``oryon_tpu/data/cache.py``.  Every item a reader
decodes (PNG/JPEG work on the host) is kept, so that a second pass over a
split, or the second view of a scene image, reuses the arrays, with exact
numerics (bit-identical items, verified on store).

Design points:
  * arrays are stored compactly (rgb re-packed to uint8 when the f32/255
    round-trip is exact — true for all shipped readers — depth/mask as the
    reader produced them);
  * every ``get_item`` returns FRESH arrays, so in-place augmentation
    downstream can never poison the cache;
  * ``max_bytes`` bounds memory with LRU eviction (default 16 GiB);
  * any other attribute (``name``, ``root``, ``object_info``, ...) passes
    through to the wrapped reader, so ``CachedReader(reader)`` is a drop-in
    anywhere a reader is accepted.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np


def _nbytes(v: Any) -> int:
    return v.nbytes if isinstance(v, np.ndarray) else 64


class CachedReader:
    def __init__(self, reader, max_bytes: Optional[int] = 16 << 30,
                 rgb_u8: bool = False):
        self._reader = reader
        self._max_bytes = max_bytes
        # rgb_u8=True returns cached rgb as uint8 instead of re-expanding to
        # f32/255 on every hit.  Only valid when the downstream path does no
        # host-side color math on rgb; collate ships uint8 either way.
        self._rgb_u8 = rgb_u8
        self._cache: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __getattr__(self, name: str):
        return getattr(self._reader, name)

    # -- store/load ---------------------------------------------------------

    @staticmethod
    def _pack(item: Dict[str, Any]) -> Dict[str, Any]:
        stored = {}
        for k, v in item.items():
            if k == "rgb" and isinstance(v, np.ndarray) and v.dtype == np.float32:
                u8 = np.round(v * 255.0).astype(np.uint8)
                if np.array_equal(u8.astype(np.float32) / 255.0, v):
                    stored[k] = ("rgb_u8", u8)
                    continue
            stored[k] = ("raw", v)
        return stored

    def _unpack(self, stored: Dict[str, Any]) -> Dict[str, Any]:
        item = {}
        for k, (tag, v) in stored.items():
            if tag == "rgb_u8":
                item[k] = v.copy() if self._rgb_u8 else v.astype(np.float32) / 255.0
            elif isinstance(v, np.ndarray):
                item[k] = v.copy()
            elif isinstance(v, list):
                item[k] = list(v)
            else:
                item[k] = v
        return item

    def get_item(self, scene_id, img_id=None, cat_id=None, *,
                 mask_type: str = "oracle") -> Dict[str, Any]:
        key = (scene_id, img_id, cat_id, mask_type)
        stored = self._cache.get(key)
        if stored is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return self._unpack(stored)
        self.misses += 1
        item = self._reader.get_item(scene_id, img_id, cat_id,
                                     mask_type=mask_type)
        stored = self._pack(item)
        size = sum(_nbytes(v) for _, v in stored.values())
        if self._max_bytes is None or size <= self._max_bytes:
            self._cache[key] = stored
            self._bytes += size
            while self._max_bytes is not None and self._bytes > self._max_bytes:
                _, old = self._cache.popitem(last=False)
                self._bytes -= sum(_nbytes(v) for _, v in old.values())
        return self._unpack(stored)

    def stats(self) -> Dict[str, int]:
        return {"items": len(self._cache), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses}
