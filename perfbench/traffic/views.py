"""Geometrically consistent RGB-D view pairs, generated from a seed.

A frozen copy of the served package's synthetic generator: an object is a
textured, smoothly curved depth patch in the anchor view, moved by a random
rigid pose and reprojected, z-buffered, into the query view.  Views are full
frames as a camera gives them (RGB uint8 and depth in millimetres), with the
REAL275 camera.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

REAL275_K = np.array([591.0125, 0, 322.525, 0, 590.16775, 244.11084, 0, 0, 1], np.float32)


def _random_pose(rs: np.random.RandomState, max_angle: float, max_shift: float) -> np.ndarray:
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    ang = rs.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    T[:3, 3] = rs.uniform(-max_shift, max_shift, 3)
    return T


def view_pair(rs: np.random.RandomState, hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """{rgb_a, rgb_q [H, W, 3] uint8, depth_a, depth_q [H, W] f32 mm, pose [4, 4]}."""
    OH, OW = hw
    fx, fy, cx, cy = REAL275_K[0], REAL275_K[4], REAL275_K[2], REAL275_K[5]
    oh, ow = rs.randint(OH // 5, OH // 3), rs.randint(OW // 5, OW // 3)
    oy, ox = rs.randint(OH // 8, OH - oh - OH // 8), rs.randint(OW // 8, OW - ow - OW // 8)
    depth_a = np.zeros((OH, OW), np.float32)
    ry = np.arange(oh, dtype=np.float32)[:, None]
    rx = np.arange(ow, dtype=np.float32)[None, :]
    depth_a[oy:oy + oh, ox:ox + ow] = (700.0 + 25.0 * np.sin(ry / 25.0) + 20.0 * np.cos(rx / 30.0)
                                       + 0.4 * ry + 0.3 * rx)
    rgb_a = rs.rand(OH, OW, 3).astype(np.float32) * 0.3
    rgb_a[oy:oy + oh, ox:ox + ow] = rs.rand(oh, ow, 3)
    ys, xs = np.nonzero(depth_a > 0)
    z = depth_a[ys, xs] / 1000.0
    pts = np.stack([(xs - cx) * z / fx, (ys - cy) * z / fy, z], 1)
    for attempt in range(20):   # a pose that keeps the object in frame
        T = _random_pose(rs, 0.5 / (1 + attempt * 0.2), 0.08 / (1 + attempt * 0.3))
        ptsq = pts @ T[:3, :3].T + T[:3, 3]
        uf = ptsq[:, 0] / ptsq[:, 2] * fx + cx
        vf = ptsq[:, 1] / ptsq[:, 2] * fy + cy
        if ((uf >= 1) & (uf < OW - 1) & (vf >= 1) & (vf < OH - 1)).mean() > 0.9:
            break
    u = np.clip(np.round(uf).astype(int), 0, OW - 1)
    v = np.clip(np.round(vf).astype(int), 0, OH - 1)
    depth_q = np.full((OH, OW), np.inf, np.float32)
    rgb_q = rs.rand(OH, OW, 3).astype(np.float32) * 0.3
    zq = ptsq[:, 2] * 1000.0
    for dv in (-1, 0, 1):       # z-buffered 3x3 splat
        for du in (-1, 0, 1):
            np.minimum.at(depth_q, (np.clip(v + dv, 0, OH - 1), np.clip(u + du, 0, OW - 1)), zq)
    order = np.argsort(-zq)     # the nearest surface's texture wins
    rgb_q[v[order], u[order]] = rgb_a[ys[order], xs[order]]
    depth_q = np.where(np.isinf(depth_q), 0.0, depth_q).astype(np.float32)

    def u8(x):
        return np.clip(x * 255.0, 0, 255).astype(np.uint8)

    return {"rgb_a": u8(rgb_a), "rgb_q": u8(rgb_q), "depth_a": depth_a, "depth_q": depth_q,
            "pose": T}
