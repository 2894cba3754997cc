"""Triangle-mesh depth rasterisers for VSD, batched over poses.

Counterpart of ``oryon_tpu/eval/renderer.py``, as PyTorch ops on the
device of the mesh's tensors:

  * ``render_depth_window`` is the scoring path: a gather z-buffer over a
    fixed window around the object's projected bbox.  Screen-space
    barycentrics and 1/z are affine in the pixel coordinates, so every
    (pixel, face) coverage test is a few multiply-adds and the depth is a
    maximum of 1/z over faces; the faces are walked ``chunk`` at a time
    (the JAX package's ``lax.scan``), so the intermediates stay
    [poses, chunk, Hw, Ww] whatever the face count, and the result does not
    depend on the chunk (a maximum is exact in any order).
  * ``render_depth`` is the full-frame scatter-min z-buffer (each triangle
    rasterises a tile x tile footprint at its screen bbox; the reference
    render for the gather path).

Vertices are projected with the CV pinhole model; depth is perspective-
correct (1/z interpolates linearly in screen space).  Every vertex
transform is an explicit multiply-add in f32, so no TF32 product can reach
the scores.  No hand kernel yet: ROADMAP queue 1 item 8 keeps the window
render as a candidate.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Mesh(NamedTuple):
    vertices: torch.Tensor    # [V, 3] f32 (mm, model frame)
    faces: torch.Tensor       # [F, 3] int64 (padded with 0, 0, 0 rows)
    face_valid: torch.Tensor  # [F] bool


def subdivide_mesh(vertices: np.ndarray, faces: np.ndarray, max_edge: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint-subdivide triangles until every edge is <= max_edge (host).
    An edge of e mm at depth z mm projects to at most e*f/z px, so this
    bounds each triangle's footprint for the scatter rasteriser's tile."""
    V = [tuple(v) for v in np.asarray(vertices, np.float64)]
    F = [tuple(f) for f in np.asarray(faces, np.int64)]
    for _ in range(12):  # hard cap on subdivision rounds
        Va = np.asarray(V)
        needs, keep = [], []
        for tri in F:
            e = Va[list(tri)]
            m = max(np.linalg.norm(e[0] - e[1]), np.linalg.norm(e[1] - e[2]),
                    np.linalg.norm(e[2] - e[0]))
            (needs if m > max_edge else keep).append(tri)
        if not needs:
            break
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                cache[key] = len(V)
                V.append(tuple((np.asarray(V[i]) + np.asarray(V[j])) / 2.0))
            return cache[key]

        for a, b, c in needs:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            keep += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        F = keep
    return np.asarray(V, np.float32), np.asarray(F, np.int32)


def pad_mesh(vertices: np.ndarray, faces: np.ndarray, n_faces: Optional[int] = None,
             max_edge: Optional[float] = None, device="cpu") -> Mesh:
    """Pad/truncate a host mesh to a fixed face count (None = exact fit),
    optionally after subdividing so every edge is <= max_edge; tensors on
    ``device``."""
    if max_edge is not None:
        vertices, faces = subdivide_mesh(vertices, faces, max_edge)
    F = faces.shape[0]
    if n_faces is None:
        n_faces = F
    elif F > n_faces:
        warnings.warn(f"pad_mesh: truncating {F} faces to {n_faces}")
    fv = np.zeros(n_faces, bool)
    out = np.zeros((n_faces, 3), np.int64)
    take = min(F, n_faces)
    out[:take] = faces[:take]
    fv[:take] = True
    return Mesh(torch.as_tensor(np.asarray(vertices, np.float32), device=device),
                torch.as_tensor(out, device=device), torch.as_tensor(fv, device=device))


def mesh_to(mesh: Mesh, device) -> Mesh:
    return Mesh(*(t.to(device) for t in mesh))


def _camera_frame(mesh: Mesh, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Vertices in the camera frame, [..., V, 3] for R [..., 3, 3] and t
    [..., 3]: R v + t as explicit f32 multiply-adds."""
    v = mesh.vertices
    R = R[..., None, :, :]                       # [..., 1, 3, 3]
    return (v[:, None, :] * R).sum(-1) + t[..., None, :]


def _project(cam: torch.Tensor, K: torch.Tensor, zs: torch.Tensor):
    u = cam[..., 0] / zs * K[..., 0, 0, None] + K[..., 0, 2, None]
    v = cam[..., 1] / zs * K[..., 1, 1, None] + K[..., 1, 2, None]
    return u, v


def render_depth(mesh: Mesh, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
                 hw: Tuple[int, int] = (480, 640), tile: int = 16) -> torch.Tensor:
    """Render the model depth (mm) under one pose (R [3, 3], t [3] mm) into
    an [H, W] frame; 0 where no surface."""
    H, W = hw
    dev = mesh.vertices.device
    cam = _camera_frame(mesh, R, t)
    z = cam[:, 2]
    u, v = _project(cam, K, z)
    tri = mesh.faces
    tz, tu, tv = z[tri], u[tri], v[tri]                  # [F, 3]
    front = torch.all(tz > 1e-3, dim=-1) & mesh.face_valid
    x0 = torch.floor(tu.amin(-1)).to(torch.int32)
    y0 = torch.floor(tv.amin(-1)).to(torch.int32)
    d = torch.arange(tile, dtype=torch.int32, device=dev)
    px = (x0[:, None, None] + d[None, None, :]).float()   # [F, T, T]
    py = (y0[:, None, None] + d[None, :, None]).float()
    x1, x2, x3 = (tu[:, i, None, None] for i in range(3))
    y1, y2, y3 = (tv[:, i, None, None] for i in range(3))
    det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    l1 = ((y2 - y3) * (px - x3) + (x3 - x2) * (py - y3)) / det
    l2 = ((y3 - y1) * (px - x3) + (x1 - x3) * (py - y3)) / det
    l3 = 1.0 - l1 - l2
    eps = -1e-5
    inside = (l1 >= eps) & (l2 >= eps) & (l3 >= eps)
    inv_z = (l1 / tz[:, 0, None, None] + l2 / tz[:, 1, None, None]
             + l3 / tz[:, 2, None, None])
    depth = 1.0 / torch.clamp(inv_z, min=1e-9)
    xi, yi = px.to(torch.int32), py.to(torch.int32)
    ok = inside & front[:, None, None] & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = (yi * W + xi).long()[ok]
    zbuf = torch.full((H * W,), float("inf"), dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, flat, depth[ok], reduce="amin", include_self=True)
    img = zbuf.reshape(H, W)
    return torch.where(torch.isinf(img), torch.zeros_like(img), img)


def render_depth_batch(mesh: Mesh, Rs, ts, K, hw=(480, 640), tile: int = 16):
    """``render_depth`` over poses: Rs [B, 3, 3], ts [B, 3] -> [B, H, W]."""
    return torch.stack([render_depth(mesh, R, t, K, hw, tile) for R, t in zip(Rs, ts)])


def _face_affine(mesh: Mesh, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor):
    """Per-face affine coefficients under poses R [..., 3, 3], t [..., 3]
    and intrinsics K [..., 3, 3].

    Returns (coeffs [..., F, 9], front [..., F], tu, tv [..., F, 3]), coeffs
    holding (a1, b1, c1, a2, b2, c2, az, bz, cz) such that at pixel (px, py)
        l1 = a1*px + b1*py + c1, l2 = a2*px + b2*py + c2,
        1/z = az*px + bz*py + cz (perspective-correct inverse depth).
    Faces failing the front/validity test get empty coverage (c1 = -1)."""
    cam = _camera_frame(mesh, R, t)
    z = cam[..., 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u, v = _project(cam, K, zs)
    tri = mesh.faces
    tz, tu, tv = z[..., tri], u[..., tri], v[..., tri]    # [..., F, 3]
    front = torch.all(tz > 1e-3, dim=-1) & mesh.face_valid
    x1, x2, x3 = tu.unbind(-1)
    y1, y2, y3 = tv.unbind(-1)
    det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    a1 = (y2 - y3) / det
    b1 = (x3 - x2) / det
    c1 = -(a1 * x3 + b1 * y3)
    a2 = (y3 - y1) / det
    b2 = (x1 - x3) / det
    c2 = -(a2 * x3 + b2 * y3)
    # 1/z = l1*iz1 + l2*iz2 + (1-l1-l2)*iz3
    iz = 1.0 / torch.clamp(tz, min=1e-3)
    d1, d2 = iz[..., 0] - iz[..., 2], iz[..., 1] - iz[..., 2]
    az = a1 * d1 + a2 * d2
    bz = b1 * d1 + b2 * d2
    cz = c1 * d1 + c2 * d2 + iz[..., 2]
    zero = torch.zeros_like(a1)
    coeffs = torch.stack([torch.where(front, c, zero if i != 2 else -torch.ones_like(a1))
                          for i, c in enumerate((a1, b1, c1, a2, b2, c2, az, bz, cz))], -1)
    return coeffs, front, tu, tv


def projected_bbox(mesh: Mesh, R, t, K, hw=(480, 640)):
    """Screen bbox of the valid front faces, clipped to the image.

    Returns (lo_yx, hi_yx [..., 2] f32 inclusive pixel bounds, floor/ceil'd,
    any_front [...]): empty -> lo = 0, hi = -1."""
    H, W = hw
    _, front, tu, tv = _face_affine(mesh, R, t, K)
    f = front[..., None]
    inf = torch.tensor(float("inf"), device=tu.device)
    lo = torch.stack([torch.floor(torch.where(f, tv, inf).amin((-2, -1))),
                      torch.floor(torch.where(f, tu, inf).amin((-2, -1)))], -1)
    hi = torch.stack([torch.ceil(torch.where(f, tv, -inf).amax((-2, -1))),
                      torch.ceil(torch.where(f, tu, -inf).amax((-2, -1)))], -1)
    lim = torch.tensor([H - 1, W - 1], dtype=torch.float32, device=tu.device)
    lo = torch.minimum(torch.clamp(lo, min=0.0), lim)
    hi = torch.minimum(torch.clamp(hi, min=0.0), lim)
    any_front = front.any(-1)
    lo = torch.where(any_front[..., None], lo, torch.zeros_like(lo))
    hi = torch.where(any_front[..., None], hi, -torch.ones_like(hi))
    return lo, hi, any_front


def render_depth_window(mesh: Mesh, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
                        origin: torch.Tensor, window: Tuple[int, int] = (128, 128),
                        chunk: int = 512) -> torch.Tensor:
    """Gather-rasterise the model depth (mm) inside windows; 0 = no surface.

    R [..., 3, 3], t [..., 3] (mm), K [..., 3, 3], origin [..., 2] int (y0,
    x0) window corner in absolute pixels -> [..., Hw, Ww].  The z-buffer of
    ``render_depth`` restricted to the window (up to float association at
    triangle edges), with no footprint limit."""
    Hw, Ww = window
    coeffs, _, _, _ = _face_affine(mesh, R, t, K)            # [..., F, 9]
    lead = coeffs.shape[:-2]
    coeffs = coeffs.reshape(-1, *coeffs.shape[-2:])          # [P, F, 9]
    org = origin.reshape(-1, 2).float()
    dev = coeffs.device
    px = org[:, 1, None] + torch.arange(Ww, dtype=torch.float32, device=dev)  # [P, Ww]
    py = org[:, 0, None] + torch.arange(Hw, dtype=torch.float32, device=dev)  # [P, Hw]
    eps = -1e-5
    best = torch.zeros((coeffs.shape[0], Hw, Ww), dtype=torch.float32, device=dev)
    for f0 in range(0, coeffs.shape[1], chunk):
        a1, b1, c1, a2, b2, c2, az, bz, cz = coeffs[:, f0:f0 + chunk].unbind(-1)  # [P, c]
        # row-factored: the py term is [P, c, Hw], only the px FMA is per pixel
        r1 = (b1[..., None] * py[:, None, :] + c1[..., None])[..., None]
        r2 = (b2[..., None] * py[:, None, :] + c2[..., None])[..., None]
        rz = (bz[..., None] * py[:, None, :] + cz[..., None])[..., None]
        pxx = px[:, None, None, :]
        l1 = a1[..., None, None] * pxx + r1                  # [P, c, Hw, Ww]
        l2 = a2[..., None, None] * pxx + r2
        iz = az[..., None, None] * pxx + rz
        cov = torch.minimum(torch.minimum(l1, l2), 1.0 - l1 - l2) >= eps
        iz = torch.where(cov, iz, torch.zeros_like(iz))
        best = torch.maximum(best, iz.amax(1))
    out = torch.where(best > 1e-9, 1.0 / torch.clamp(best, min=1e-9), torch.zeros_like(best))
    return out.reshape(*lead, Hw, Ww)


def max_screen_footprint(mesh: Mesh, R, t, K) -> torch.Tensor:
    """Diagnostic: the largest triangle bbox edge in pixels under a pose
    (must stay below the scatter rasteriser's tile)."""
    cam = _camera_frame(mesh, R, t)
    z = torch.clamp(cam[:, 2], min=1e-3)
    u, v = _project(cam, K, z)
    tri = mesh.faces
    du = u[tri].amax(-1) - u[tri].amin(-1)
    dv = v[tri].amax(-1) - v[tri].amin(-1)
    return (torch.maximum(du, dv) * mesh.face_valid).amax()
