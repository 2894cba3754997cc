"""Synthetic geometrically consistent RGBD pair batches.

Counterpart of ``oryon_tpu/data/synthetic.py``, the port's own copy: an
"object" is a textured depth blob in the anchor view; its point cloud is
moved by a random pose and reprojected into the query view, and the pixel
correspondences are recorded, so matching, lifting and registration see
physically consistent data with a known relative pose.  The draws are numpy
``RandomState`` draws in the JAX package's order, so the arrays are those
of the JAX package bit for bit; ``synthetic_pair_batch`` puts them on a
torch device (depths as f32 of their uint16 values, as ``collate`` does).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from oryon_tpu_torch.data.pair_batch import PairBatch, PairView

DEFAULT_K = np.array([591.0125, 0, 322.525, 0, 590.16775, 244.11084, 0, 0, 1], np.float32)


def _random_pose(rs: np.random.RandomState, max_angle: float = 0.5,
                 max_shift: float = 0.08) -> np.ndarray:
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    ang = rs.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rs.uniform(-max_shift, max_shift, 3)
    return T


def synthetic_pair(
    rs: np.random.RandomState,
    img_hw: Tuple[int, int] = (224, 224),
    orig_hw: Tuple[int, int] = (480, 640),
    n_corrs: int = 500,
):
    """One synthetic pair in numpy; returns dict of per-view arrays + GT."""
    H, W = img_hw
    OH, OW = orig_hw
    K = DEFAULT_K.reshape(3, 3)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    # object = square patch at random position in the anchor original frame
    # (sizes/margins proportional to the frame so small frames work too)
    oh = rs.randint(OH // 5, OH // 3)
    ow = rs.randint(OW // 5, OW // 3)
    oy = rs.randint(OH // 8, OH - oh - OH // 8)
    ox = rs.randint(OW // 8, OW - ow - OW // 8)
    depth_a = np.zeros((OH, OW), np.float32)
    # smooth surface (gradients ~1 mm/px) so pixel-rounding of correspondence
    # coordinates stays geometrically consistent
    ry = np.arange(oh, dtype=np.float32)[:, None]
    rx = np.arange(ow, dtype=np.float32)[None, :]
    zs = (700.0 + 25.0 * np.sin(ry / 25.0) + 20.0 * np.cos(rx / 30.0)
          + 0.4 * ry + 0.3 * rx).astype(np.float32)
    depth_a[oy:oy + oh, ox:ox + ow] = zs
    mask_a_orig = (depth_a > 0).astype(np.uint8)
    rgb_a = rs.rand(OH, OW, 3).astype(np.float32) * 0.3
    tex = rs.rand(oh, ow, 3).astype(np.float32)
    rgb_a[oy:oy + oh, ox:ox + ow] = tex

    # lift object pixels, transform by GT pose (meters), reproject to query
    ys, xs = np.nonzero(mask_a_orig)
    z = depth_a[ys, xs] / 1000.0
    pts = np.stack([(xs - cx) * z / fx, (ys - cy) * z / fy, z], 1)
    # resample the pose until the transformed object stays in frame
    for attempt in range(20):
        T = _random_pose(rs, max_angle=0.5 / (1 + attempt * 0.2),
                         max_shift=0.08 / (1 + attempt * 0.3))
        ptsq = pts @ T[:3, :3].T + T[:3, 3]
        uf = ptsq[:, 0] / ptsq[:, 2] * fx + cx
        vf = ptsq[:, 1] / ptsq[:, 2] * fy + cy
        in_frame = ((uf >= 1) & (uf < OW - 1) & (vf >= 1) & (vf < OH - 1)).mean()
        if in_frame > 0.9:
            break
    u = np.clip(np.round(uf).astype(int), 0, OW - 1)
    v = np.clip(np.round(vf).astype(int), 0, OH - 1)

    depth_q = np.full((OH, OW), np.inf, np.float32)
    rgb_q = rs.rand(OH, OW, 3).astype(np.float32) * 0.3
    mask_q_orig = np.zeros((OH, OW), np.uint8)
    zq_mm = ptsq[:, 2] * 1000.0
    # z-buffered 3x3 splat: dense query depth without scatter holes, nearest
    # surface wins where the transformed object self-occludes
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            vv = np.clip(v + dv, 0, OH - 1)
            uu = np.clip(u + du, 0, OW - 1)
            np.minimum.at(depth_q, (vv, uu), zq_mm)
            mask_q_orig[vv, uu] = 1
    # z-ordered texture writes: sort far-to-near so the VISIBLE (nearest)
    # surface's texture wins where the fold self-occludes — unordered writes
    # could pair a near-depth correspondence with a far point's texture
    order = np.argsort(-zq_mm)
    rgb_q[v[order], u[order]] = rgb_a[ys[order], xs[order]]
    depth_q = np.where(np.isinf(depth_q), 0.0, depth_q)

    # correspondences only for CO-VISIBLE points (the reference builds GT
    # corrs by 3D-NN at 2mm between lifted clouds, make_nocs_test.py:47-86,
    # which likewise excludes self-occluded points)
    visible = np.abs(depth_q[v, u] - zq_mm) < 2.0
    vis_idx = np.nonzero(visible)[0]
    sel = rs.choice(vis_idx, min(n_corrs, len(vis_idx)), replace=False)
    corr = np.stack([ys[sel], xs[sel], v[sel], u[sel]], 1).astype(np.float32)
    corr[:, 0] *= H / OH
    corr[:, 1] *= W / OW
    corr[:, 2] *= H / OH
    corr[:, 3] *= W / OW
    corrs = np.zeros((n_corrs, 4), np.int32)
    corrs[: len(sel)] = np.clip(corr, 0, [H - 1, W - 1, H - 1, W - 1]).astype(np.int32)
    corr_valid = np.zeros(n_corrs, bool)
    corr_valid[: len(sel)] = True

    def down(img, hw):
        # floor-grid stride resize with the SAME index convention as the
        # corr rescale (y_out = y*h/OH): a linspace grid disagrees by up to
        # ~1 px at frame edges, silently skewing GT correspondences
        sy = np.arange(hw[0]) * img.shape[0] // hw[0]
        sx = np.arange(hw[1]) * img.shape[1] // hw[1]
        return img[sy][:, sx]

    pose_a = np.eye(4, dtype=np.float32)
    pose_a[2, 3] = 0.75
    return dict(
        rgb_a=down(rgb_a, img_hw), rgb_q=down(rgb_q, img_hw),
        mask_a=down(mask_a_orig, img_hw), mask_q=down(mask_q_orig, img_hw),
        depth_a=down(depth_a, img_hw), depth_q=down(depth_q, img_hw),
        orig_depth_a=depth_a, orig_depth_q=depth_q,
        corrs=corrs, corr_valid=corr_valid,
        rel_pose=T.astype(np.float32), pose_a=pose_a,
        pose_q=(T @ pose_a).astype(np.float32),
    )


def synthetic_pair_batch(
    seed: int = 0,
    batch: int = 4,
    img_hw: Tuple[int, int] = (224, 224),
    orig_hw: Tuple[int, int] = (480, 640),
    n_corrs: int = 500,
    n_prompts: int = 8,
    context_len: int = 77,
    vocab: int = 49408,
    device="cpu",
) -> PairBatch:
    """A batch of ``synthetic_pair``s from ``RandomState(seed)`` on ``device``."""
    rs = np.random.RandomState(seed)
    items = [synthetic_pair(rs, img_hw, orig_hw, n_corrs) for _ in range(batch)]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def stack(k):
        return t(np.stack([it[k] for it in items]))

    def depth(k):
        return t(np.clip(np.stack([it[k] for it in items]), 0, 65535)
                 .astype(np.uint16).astype(np.float32))

    prompt_ids = np.zeros((batch, n_prompts, context_len), np.int32)
    prompt_ids[:, :, 0] = vocab - 2
    prompt_ids[:, :, 1] = rs.randint(1, min(vocab - 3, 400), (batch, n_prompts))
    prompt_ids[:, :, 2] = vocab - 1

    def view(side):
        orig_depth = depth(f"orig_depth_{side}")
        return PairView(
            rgb=t(np.clip(np.stack([it[f"rgb_{side}"] for it in items]) * 255.0,
                          0, 255).astype(np.uint8)),
            mask=stack(f"mask_{side}"),
            depth=depth(f"depth_{side}"),
            orig_depth=orig_depth,
            eval_depth=orig_depth,
            camera=t(np.tile(DEFAULT_K[None], (batch, 1))),
            pose=stack(f"pose_{side}"),
            size=t(np.tile(np.array(orig_hw, np.int32)[None], (batch, 1))),
        )

    return PairBatch(
        anchor=view("a"), query=view("q"),
        prompt_ids=t(prompt_ids),
        corrs=stack("corrs"), corr_valid=stack("corr_valid"),
        valid=t(np.ones((batch,), np.float32)),
        rel_pose=stack("rel_pose"),
        cls_id=np.arange(batch),
        instance_id=np.array([f"syn_{i}" for i in range(batch)]),
        id_a=np.array([f"0 {i} obj{i}" for i in range(batch)]),
        id_q=np.array([f"1 {i} obj{i}" for i in range(batch)]),
    )
