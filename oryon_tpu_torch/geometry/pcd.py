"""Point-cloud helpers: depth lifting, rigid transforms, distance matrices.

Counterpart of ``oryon_tpu/geometry/pcd.py``.  Everything is float32 and
batched over leading dimensions; matmuls run in full f32 (TF32 is off in the
serving engine, see ``infer.OryonPredictor``).
"""
from __future__ import annotations

import torch


def lift_pcd(depth: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Backproject a whole depth image [H, W] with the row-major intrinsics
    ``camera`` [9] to [H*W, 3] points in the depth's unit; a pixel of depth 0
    lifts to the origin."""
    H, W = depth.shape
    fx, cx, fy, cy = camera[0], camera[2], camera[4], camera[5]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    d = depth.float()
    px = (xs - cx) * d / fx
    py = (ys - cy) * d / fy
    return torch.stack([px.reshape(-1), py.reshape(-1), d.reshape(-1)], dim=1)


def lift_pcd_at(depth: torch.Tensor, camera: torch.Tensor,
                yx: torch.Tensor) -> torch.Tensor:
    """Backproject depth at integer (y, x) coordinates, batched.

    depth: [B, H, W]; camera: [B, 9] row-major K; yx: [B, N, 2] in bounds.
    Returns [B, N, 3] in the depth's unit.
    """
    B, H, W = depth.shape
    y = yx[..., 0].long()
    x = yx[..., 1].long()
    d = torch.gather(depth.reshape(B, H * W).float(), 1, y * W + x)
    fx, cx = camera[:, 0:1].float(), camera[:, 2:3].float()
    fy, cy = camera[:, 4:5].float(), camera[:, 5:6].float()
    px = (x.float() - cx) * d / fx
    py = (y.float() - cy) * d / fy
    return torch.stack([px, py, d], dim=-1)


def transform_pcd(pcd: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rigid transform of (..., N, 3) points; R (..., 3, 3), t (..., 3)."""
    return torch.einsum("...ij,...nj->...ni", R, pcd) + t[..., None, :]


def transform_pcd_h(pcd: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) homogeneous transform to (..., N, 3) points."""
    return transform_pcd(pcd, T[..., :3, :3], T[..., :3, 3])


def sq_dist_matrix(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (..., N, M) via the matmul expansion."""
    a2 = torch.sum(A * A, dim=-1, keepdim=True)
    b2 = torch.sum(B * B, dim=-1, keepdim=True)
    ab = torch.einsum("...nd,...md->...nm", A, B)
    return torch.clamp(a2 - 2.0 * ab + b2.transpose(-1, -2), min=0.0)


def unit(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalise the last axis with an epsilon guard."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def cosine_matrix(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity matrix (..., N, M) as one normalised matmul."""
    return torch.einsum("...nd,...md->...nm", unit(A, eps), unit(B, eps))


def inv_norm_cosine(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Inverted, [0, 1]-normalised cosine distance: 0.5 * (1 - cos)."""
    return 0.5 * (1.0 - cosine_matrix(A, B))


def pairwise_dist(A: torch.Tensor, B: torch.Tensor, kind: str = "L2") -> torch.Tensor:
    """Pairwise distance matrix (..., N, M) of kind "L2", "SquareL2",
    "inv_norm_cosine" or "cosine"."""
    if kind == "L2":
        return torch.sqrt(sq_dist_matrix(A, B) + 1e-7)
    if kind == "SquareL2":
        return sq_dist_matrix(A, B)
    if kind == "inv_norm_cosine":
        return inv_norm_cosine(A, B)
    if kind == "cosine":
        return 0.5 * (cosine_matrix(A, B) + 1.0)
    raise NotImplementedError(kind)


def diameter(pts: torch.Tensor) -> torch.Tensor:
    """Axis-aligned extent of (..., N, 3+) points: the largest per-axis
    range, not the farthest pair."""
    xyz = pts[..., :3]
    return torch.amax(xyz.amax(dim=-2) - xyz.amin(dim=-2), dim=-1)


def sample_select(uniforms: torch.Tensor, n_avail) -> torch.Tensor:
    """Uniform sampling with replacement into a fixed-capacity buffer:
    ``uniforms`` [capacity] in [0, 1) -> int32 indices in [0, n_avail).  The
    caller draws the uniforms (the JAX version draws them from its key)."""
    n = torch.as_tensor(n_avail, device=uniforms.device).float()
    return torch.floor(uniforms * n).to(torch.int32)
