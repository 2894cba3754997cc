"""Rigid registration: weighted Kabsch, parallel RANSAC, trimmed masked ICP.

Counterpart of ``oryon_tpu/geometry/kabsch.py``, batched over leading
dimensions (the JAX package ``vmap``s over pairs).  All pose math runs in
float32 with full-precision matmuls: the serving engine turns TF32 off, the
PyTorch counterpart of the JAX package's ``fp32_matmul`` policy.
Randomness enters as tensors (``ransac_kabsch``'s uniforms), never drawn here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from oryon_tpu_torch.geometry.pcd import sq_dist_matrix, transform_pcd


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=torch.float32, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _centered_cov(A, B, weights, eps):
    A = A.float()
    B = B.float()
    w = (torch.ones(A.shape[:-1], device=A.device) if weights is None
         else weights.float())
    wsum = torch.sum(w, dim=-1, keepdim=True) + eps
    cA = torch.sum(A * w[..., None], dim=-2) / wsum
    cB = torch.sum(B * w[..., None], dim=-2) / wsum
    Am = A - cA[..., None, :]
    Bm = B - cB[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", Am, w, Bm)
    return H, cA, cB


def weighted_kabsch(A: torch.Tensor, B: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """Least-squares rigid transform T (..., 4, 4) mapping A -> B.

    A, B: (..., N, 3); weights: (..., N) nonnegative.  Reflections are
    fixed with the determinant sign, as in the JAX version.
    """
    H, cA, cB = _centered_cov(A, B, weights, eps)
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    det = _det3(V @ U.transpose(-1, -2))
    D = torch.zeros_like(H)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    R = V @ D @ U.transpose(-1, -2)
    t = cB - torch.einsum("...ij,...j->...i", R, cA)
    return _compose(R, t)


def kabsch(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Unweighted rigid fit A -> B."""
    return weighted_kabsch(A, B, None)


def weighted_kabsch_quat(A: torch.Tensor, B: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         eps: float = 1e-6,
                         power_iters: int = 100) -> torch.Tensor:
    """Rigid fit via Horn's quaternion method: the rotation is the leading
    eigenvector of the symmetric 4x4 quaternion matrix, found by a fixed
    number of power iterations.  Same estimator as ``weighted_kabsch``."""
    S, cA, cB = _centered_cov(A, B, weights, eps)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    # shift so the largest eigenvalue is also the largest in magnitude
    shift = torch.sum(torch.abs(K), dim=-1).amax(dim=-1)
    Ks = K + shift[..., None, None] * torch.eye(4, device=K.device)
    q = torch.ones(K.shape[:-1], device=K.device)
    for _ in range(power_iters):
        q = torch.einsum("...ij,...j->...i", Ks, q)
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-20)
    qw, qx, qy, qz = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)
    t = cB - torch.einsum("...ij,...j->...i", R, cA)
    return _compose(R, t)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] gathered at idx [B, ...] along axis 1."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = x[torch.arange(B, device=x.device)[:, None], flat]
    return out.reshape(idx.shape + x.shape[2:])


def ransac_kabsch(A: torch.Tensor, B: torch.Tensor, valid: torch.Tensor,
                  uniforms: torch.Tensor, match_err: float = 0.001
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel-hypothesis RANSAC + inlier refit, batched over pairs.

    A, B: [P, N, 3] matched points; valid: [P, N] 0/1; uniforms: [P, H, 4]
    in [0, 1), one minimal set of 4 rows per hypothesis drawn from the valid
    rows by inverse CDF.  Returns (T [P, 4, 4], inlier count [P]).
    """
    if A.shape != B.shape:
        raise ValueError(f"ransac_kabsch: A and B must match, got "
                         f"{tuple(A.shape)} vs {tuple(B.shape)}")
    P, N, _ = A.shape
    H = uniforms.shape[1]
    valid = valid.float()
    n_valid = torch.sum(valid, dim=-1, keepdim=True)
    cdf = torch.cumsum(valid, dim=-1) / torch.clamp(n_valid, min=1.0)
    # right side: u == 0 must not select row 0 when it is invalid
    idx = torch.searchsorted(cdf.contiguous(), uniforms.reshape(P, -1).contiguous(),
                             right=True).reshape(P, H, 4).clamp(0, N - 1)
    T_min = weighted_kabsch_quat(_take(A, idx), _take(B, idx))       # [P, H, 4, 4]
    T_all = weighted_kabsch(A, B, valid)[:, None]                    # [P, 1, 4, 4]
    T_hyp = torch.cat([T_all, T_min], dim=1)
    pred = transform_pcd(A[:, None], T_hyp[..., :3, :3], T_hyp[..., :3, 3])
    err = torch.linalg.norm(pred - B[:, None], dim=-1)               # [P, H+1, N]
    inl = (err <= match_err).float() * valid[:, None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(P, device=A.device)
    T_refit = weighted_kabsch(A, B, inl[rows, best])
    enough = counts[rows, best] >= 4.0
    T = torch.where(enough[:, None, None], T_refit, T_hyp[rows, best])
    return T, counts[rows, best]


def masked_icp(src: torch.Tensor, src_valid: torch.Tensor, dst: torch.Tensor,
               dst_valid: torch.Tensor, init_T: torch.Tensor, iters: int = 8,
               trim: float = 0.7) -> torch.Tensor:
    """Symmetric trimmed, validity-masked ICP refinement, batched over pairs.

    src [P, N, 3], dst [P, M, 3] (meters) with validity masks; init_T
    [P, 4, 4].  Each iteration matches both ways under the current pose,
    keeps the best ``trim`` fraction of each direction, and refits from the
    original points; every iterate (``init_T`` included) is scored by its
    symmetric trimmed RMS and the best one is returned.  Pairs with fewer
    than 4 valid points on a side keep ``init_T``.
    """
    N = src.shape[1]
    M = dst.shape[1]
    srcv = src_valid.bool()
    dstv = dst_valid.bool()
    n_src = srcv.sum(-1)
    n_dst = dstv.sum(-1)
    k_src = torch.clamp((trim * n_src).int(), 4, N).long()
    k_dst = torch.clamp((trim * n_dst).int(), 4, M).long()
    init_T = init_T.float()
    inf = torch.tensor(float("inf"), device=src.device)

    def match(T):
        s = transform_pcd(src, T[:, :3, :3], T[:, :3, 3])
        d2 = sq_dist_matrix(s, dst)
        d2 = torch.where(dstv[:, None, :], d2, inf)
        d2 = torch.where(srcv[:, :, None], d2, inf)
        d2f, nn_f = torch.min(d2, dim=-1)
        df = torch.where(srcv, torch.sqrt(d2f), inf)
        thr_f = torch.sort(df, dim=-1).values.gather(
            1, torch.clamp(k_src - 1, min=0)[:, None])
        wf = (srcv & (df <= thr_f) & torch.isfinite(df)).float()
        d2b, nn_b = torch.min(d2, dim=1)
        db = torch.where(dstv, torch.sqrt(d2b), inf)
        thr_b = torch.sort(db, dim=-1).values.gather(
            1, torch.clamp(k_dst - 1, min=0)[:, None])
        wb = (dstv & (db <= thr_b) & torch.isfinite(db)).float()
        wsum = wf.sum(-1) + wb.sum(-1)
        sq = (torch.where(wf > 0, df * df, 0.0).sum(-1)
              + torch.where(wb > 0, db * db, 0.0).sum(-1))
        err = torch.sqrt(sq / torch.clamp(wsum, min=1.0))
        A = torch.cat([src, _take(src, nn_b)], dim=1)
        B = torch.cat([_take(dst, nn_f), dst], dim=1)
        return A, B, torch.cat([wf, wb], dim=1), err

    T_cur = T_best = init_T
    e_best = torch.full((src.shape[0],), float("inf"), device=src.device)
    for _ in range(iters):
        A, B, w, err = match(T_cur)
        better = err < e_best
        T_best = torch.where(better[:, None, None], T_cur, T_best)
        e_best = torch.where(better, err, e_best)
        ok = torch.sum(w, dim=-1) >= 4
        T_cur = torch.where(ok[:, None, None], weighted_kabsch(A, B, w), T_cur)
    # the last refit was produced but never scored: score it too
    err_last = match(T_cur)[3]
    T_best = torch.where((err_last < e_best)[:, None, None], T_cur, T_best)
    enough = (n_src >= 4) & (n_dst >= 4)
    return torch.where(enough[:, None, None], T_best, init_T)


def icp(A: torch.Tensor, B: torch.Tensor, init_T: Optional[torch.Tensor] = None,
        max_iterations: int = 20, tolerance: float = 1e-3) -> torch.Tensor:
    """Iterative closest point A [N, 3] -> B [M, 3] with a fixed trip count:
    the cloud stops moving once the mean nearest-neighbour distance changes
    by less than ``tolerance`` between two trips.  Exact brute-force
    neighbours.  Returns the fit of A onto the moved cloud, [4, 4]."""
    if init_T is None:
        init_T = torch.eye(4, device=A.device)
    A, B = A.float(), B.float()
    src = transform_pcd(A, init_T[:3, :3].float(), init_T[:3, 3].float())
    prev_err = torch.tensor(float("inf"), device=A.device)
    done = torch.tensor(False, device=A.device)
    for _ in range(max_iterations):
        d2, nn = torch.min(sq_dist_matrix(src, B), dim=-1)
        T = weighted_kabsch(src, B[nn])
        err = torch.mean(torch.sqrt(d2 + 1e-12))
        src = torch.where(done, src, transform_pcd(src, T[:3, :3], T[:3, 3]))
        done = done | (torch.abs(prev_err - err) < tolerance)
        prev_err = err
    return weighted_kabsch(A, src)
