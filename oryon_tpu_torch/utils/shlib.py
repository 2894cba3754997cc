"""Build on first use and load the port's shared libraries: the CUDA kernels
(``ops/cuda/_lib.py``) and the host runtime (``utils/native.py``).

A library lands in ``build/oryon_tpu_torch/`` at the root of the checkout,
named by a hash of what it is built from, so an edited source is rebuilt and
an unchanged one is reused.  The build writes a process-unique temporary name
that ``os.replace`` then puts in place, so processes reaching the first call
together (xdist workers, ``torchrun`` ranks) never load a half-written file;
each caller holds its own lock against its threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "oryon_tpu_torch")


def build_and_load(build_dir: str, prefix: str, key: bytes, build: Callable[[str], None],
                   signatures: Dict[str, Tuple[Optional[type], List[type]]]
                   ) -> Tuple[ctypes.CDLL, str, float]:
    """``(library, path, build seconds)`` of ``{build_dir}/{prefix}_{hash of
    key}.so``: built first by ``build(temporary path)`` if it is not there
    (0.0 seconds when reused), loaded with ``ctypes.CDLL`` (every call
    releases the GIL) and typed from ``signatures``: name -> (restype,
    argtypes)."""
    so = os.path.join(build_dir, f"{prefix}_{hashlib.sha256(key).hexdigest()[:16]}.so")
    seconds = 0.0
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            build(tmp)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib, so, seconds
