"""Wrappers of the hand-written CUDA kernels, one module a source file.

Each wrapper adds one to a module-level count where it launches its kernel.
``reset_launch_counts`` and ``launch_counts`` set and read all of them, so a
caller can show which kernels a stretch of work went through.
"""
from __future__ import annotations

import importlib
from typing import Dict

# kernel -> (module of this package, name of its count)
_COUNTERS = {"k1": ("mha_lanes", "launches"), "k1i8": ("mha_lanes", "launches_i8"),
             "k1bwd": ("mha_lanes", "launches_bwd"),
             "k2": ("match_kernel", "launches"), "k2fp32": ("match_kernel", "launches_fp32"),
             "k3": ("swin_attn", "launches_packed"),
             "k4": ("swin_attn", "launches_band"), "k5": ("flash", "launches")}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def reset_launch_counts() -> None:
    for module, attr in _COUNTERS.values():
        setattr(_module(module), attr, 0)


def launch_counts() -> Dict[str, int]:
    """{"k1", "k1i8", "k1bwd", "k2", "k2fp32", "k3", "k4", "k5"} -> launches
    since the reset ("k1bwd" counts K1's backward, either mode; "k2" counts
    K2's bf16 mode, "k2fp32" its fp32 mode)."""
    return {key: getattr(_module(module), attr) for key, (module, attr) in _COUNTERS.items()}
