"""Argument helpers shared by the tools: ``key=value`` overrides and the
``--device`` flag (``--device cpu`` or ``--device=cpu``)."""
from __future__ import annotations

from typing import List, Optional


def flag(argv: List[str], name: str, default: Optional[str] = None) -> Optional[str]:
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def overrides(argv: List[str]) -> List[str]:
    """The ``key=value`` arguments (flags such as ``--epochs=...`` excluded)."""
    return [a for a in argv if "=" in a and not a.startswith("--")]


def device(argv: List[str]):
    """The ``--device`` of the command line (default ``cuda``), as a torch
    device; ``cuda`` without a card raises rather than running on the host.
    Turns TF32 off: the tools' products are the f32 products of the JAX
    package (``Precision.HIGHEST``)."""
    import torch

    from oryon_tpu_torch.infer import full_precision_matmuls

    dev = torch.device(flag(argv, "--device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on "
                           "the host")
    full_precision_matmuls()
    return dev
