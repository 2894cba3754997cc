"""BOP model-info helpers: symmetry-set expansion to fixed arrays.

The port's own copy of ``oryon_tpu/data/bop.py``: the BOP toolkit's
symmetry discretisation (``get_symmetry_transformations``,
``format_sym_set``) in numpy.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _axis_rotation(angle: float, axis: np.ndarray) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def symmetry_transformations(
    model_info: Dict, max_sym_disc_step: float = 0.01
) -> List[Dict[str, np.ndarray]]:
    """Discrete + discretized-continuous symmetry set (identity first)."""
    trans_disc = [{"R": np.eye(3), "t": np.zeros((3, 1))}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, np.float64), (4, 4))
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3].reshape(3, 1)})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], np.float64)
        offset = np.asarray(sym["offset"], np.float64).reshape(3, 1)
        steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / steps
        for i in range(steps):
            R = _axis_rotation(i * step, axis)
            trans_cont.append({"R": R, "t": -R @ offset + offset})

    out = []
    for td in trans_disc:
        if trans_cont:
            for tc in trans_cont:
                out.append({"R": tc["R"] @ td["R"],
                            "t": tc["R"] @ td["t"] + tc["t"]})
        else:
            out.append(td)
    return out


def format_sym_set(syms: List[Dict[str, np.ndarray]]) -> np.ndarray:
    """Symmetry dicts -> [S, 3, 4] float32 array."""
    R = np.stack([np.asarray(s["R"]) for s in syms], 0)
    t = np.stack([np.asarray(s["t"]).reshape(3, 1) for s in syms], 0)
    return np.concatenate([R, t], axis=2).astype(np.float32)


def sym_set_from_info(model_info: Dict, max_sym_disc_step: float = 0.05) -> np.ndarray:
    """Fixed-array symmetry set as the evaluator consumes it
    (reference uses max_sym_disc_step=0.05, utils/data/nocs.py:141)."""
    return format_sym_set(symmetry_transformations(model_info, max_sym_disc_step))
