"""Plain PyTorch reference of Oryon's pose stages: masked nearest-neighbour
matching, depth lifting, PointDSC (Bai et al., CVPR 2021) and trimmed ICP.

A frozen copy of the served pipeline's plain arithmetic, in float32 with
TF32 off (``matmul_precision(True)`` is the control: the same with TF32
products).  The random draws of a request are taken again (``draw_noise``)
from a generator seeded as the engine's, replaying the draws of every
request before it, in the order the served pipeline draws them.  It imports
nothing of the program.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@contextmanager
def matmul_precision(tf32: bool):
    """TF32 products on or off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Noise(NamedTuple):
    match_src: torch.Tensor   # [B, FH*FW]
    match_out: torch.Tensor   # [B, min(src_capacity, FH*FW)]
    icp_a: torch.Tensor       # [B, FH*FW]
    icp_q: torch.Tensor


def draw_noise(generator: torch.Generator, B: int, hw: int, src_capacity: int,
               device) -> Noise:
    """A request's uniforms, drawn as the served pipeline draws them (solver
    PointDSC, ICP on)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return Noise(u(B, hw), torch.clamp(u(B, min(src_capacity, hw)), min=1e-20),
                 u(B, hw), u(B, hw))


# ---------------------------------------------------------------- sampling

def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis in the IEEE total order, ties to
    the lower index (as ``jax.lax.top_k``)."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def masked_select(mask, noise, capacity):
    flat = mask.reshape(mask.shape[0], -1).float()
    idx = top_k(flat * 2.0 + noise, capacity)[1]
    return idx, torch.gather(flat, 1, idx) > 0


def flat_to_yx(idx, width):
    return torch.stack([idx // width, idx % width], dim=-1)


def unit(x, eps: float = 1e-8):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


# ---------------------------------------------------------------- matching

def source_distances(feat_a, feat_q, src_idx, mask_q):
    """f32 cosine distances 0.5 * (1 - <a, q>) of each source [B, cap] to
    every target of map q, excluded targets at +inf: [B, cap, H*W]."""
    B, H, W, D = feat_a.shape
    f1 = unit(torch.gather(feat_a.reshape(B, H * W, D).float(), 1,
                           src_idx[..., None].expand(-1, -1, D)))
    f2 = unit(feat_q.reshape(B, H * W, D).float())
    d = 0.5 * (1.0 - torch.einsum("bsd,bnd->bsn", f1, f2))
    return d.masked_fill((mask_q.reshape(B, 1, H * W) == 0), float("inf"))


# ---------------------------------------------------------------- lifting

def scale_coords(coords, source, target):
    k = coords.shape[-1] // 2
    ratio = (torch.as_tensor(target, dtype=torch.float32, device=coords.device)
             / torch.as_tensor(source, dtype=torch.float32, device=coords.device))
    return coords.float() * ratio.tile(k)


def valid_coords(coords, bounds):
    b = torch.as_tensor(bounds, dtype=torch.float32, device=coords.device)
    return ((coords[..., 0] >= 0) & (coords[..., 0] < b[..., 0])
            & (coords[..., 1] >= 0) & (coords[..., 1] < b[..., 1]))


def lift_at(depth, camera, yx):
    """depth [B, H, W] mm, camera [B, 9], yx [B, N, 2] -> [B, N, 3] mm."""
    B, H, W = depth.shape
    y, x = yx[..., 0].long(), yx[..., 1].long()
    d = torch.gather(depth.reshape(B, H * W).float(), 1, y * W + x)
    fx, cx, fy, cy = (camera[:, i:i + 1].float() for i in (0, 2, 4, 5))
    return torch.stack([(x.float() - cx) * d / fx, (y.float() - cy) * d / fy, d], dim=-1)


def _to_frame(yx, feat_hw, depth):
    """Featmap-frame (y, x) -> clamped integer pixels of the depth frame,
    and whether they lay inside it."""
    B, Ho, Wo = depth.shape
    size = torch.tensor([[Ho, Wo]], dtype=torch.float32, device=depth.device).expand(B, 2)
    c = scale_coords(yx.float(), feat_hw, size[:, None])
    ok = valid_coords(c, size[:, None])
    hi = torch.tensor([Ho - 1, Wo - 1], device=c.device)
    return torch.minimum(torch.clamp(c.int(), min=0), hi), ok


def lift_corrs(rows, valid, depth_a, depth_q, cam_a, cam_q, feat_hw):
    """Both ends of featmap-frame correspondences lifted to metres, and the
    rows that stay valid (inside both frames, depth > 0)."""
    ca, oka = _to_frame(rows[..., :2], feat_hw, depth_a)
    cq, okq = _to_frame(rows[..., 2:], feat_hw, depth_q)
    pa = lift_at(depth_a, cam_a, ca) / 1000.0
    pq = lift_at(depth_q, cam_q, cq) / 1000.0
    return pa, pq, valid & oka & okq & (pa[..., 2] > 0) & (pq[..., 2] > 0)


def mask_cloud(noise, mask, depth, camera, feat_hw, capacity):
    """Fixed-capacity cloud [B, capacity, 3] (metres) of a featmap mask."""
    idx, valid = masked_select(mask, noise, capacity)
    c, ok = _to_frame(flat_to_yx(idx, mask.shape[-1]), feat_hw, depth)
    p = lift_at(depth, camera, c) / 1000.0
    return p, valid & ok & (p[..., 2] > 0)


# ---------------------------------------------------------------- geometry

def sq_dist(A, B):
    a2 = torch.sum(A * A, dim=-1, keepdim=True)
    b2 = torch.sum(B * B, dim=-1, keepdim=True)
    return torch.clamp(a2 - 2.0 * torch.einsum("...nd,...md->...nm", A, B)
                       + b2.transpose(-1, -2), min=0.0)


def transform(p, T):
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], p) + T[..., None, :3, 3]


def _compose(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), device=R.device)
    T[..., :3, :3], T[..., :3, 3], T[..., 3, 3] = R, t, 1.0
    return T


def _centered_cov(A, B, w, eps):
    w = torch.ones(A.shape[:-1], device=A.device) if w is None else w.float()
    ws = torch.sum(w, dim=-1, keepdim=True) + eps
    cA = torch.sum(A * w[..., None], dim=-2) / ws
    cB = torch.sum(B * w[..., None], dim=-2) / ws
    H = torch.einsum("...ni,...n,...nj->...ij", A - cA[..., None, :], w, B - cB[..., None, :])
    return H, cA, cB


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def kabsch(A, B, w=None, eps: float = 1e-6):
    """Weighted least-squares rigid transform A -> B by SVD, the reflection
    fixed by the determinant's sign."""
    H, cA, cB = _centered_cov(A.float(), B.float(), w, eps)
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    D = torch.diag_embed(torch.ones(H.shape[:-1], device=H.device))
    D[..., 2, 2] = _det3(V @ U.transpose(-1, -2))
    R = V @ D @ U.transpose(-1, -2)
    return _compose(R, cB - torch.einsum("...ij,...j->...i", R, cA))


def kabsch_quat(A, B, w=None, eps: float = 1e-6, iters: int = 100):
    """The same estimator by Horn's quaternion method (power iteration)."""
    S, cA, cB = _centered_cov(A.float(), B.float(), w, eps)
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = (S[..., i, :].unbind(-1)
                                                        for i in range(3))
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1)], dim=-2)
    Ks = K + torch.sum(torch.abs(K), dim=-1).amax(dim=-1)[..., None, None] * torch.eye(
        4, device=K.device)
    q = torch.ones(K.shape[:-1], device=K.device)
    for _ in range(iters):
        q = torch.einsum("...ij,...j->...i", Ks, q)
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-20)
    w_, x, y, z = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)], -1),
        torch.stack([2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)], -1),
        torch.stack([2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    return _compose(R, cB - torch.einsum("...ij,...j->...i", R, cA))


def take(x, idx):
    """x [B, N, ...] gathered at idx [B, ...] along axis 1."""
    B = x.shape[0]
    out = x[torch.arange(B, device=x.device)[:, None], idx.reshape(B, -1)]
    return out.reshape(idx.shape + x.shape[2:])


def masked_icp(src, src_valid, dst, dst_valid, init_T, iters: int, trim: float):
    """Symmetric trimmed ICP; the best-scoring iterate (init included)."""
    N, M = src.shape[1], dst.shape[1]
    sv, dv = src_valid.bool(), dst_valid.bool()
    n_s, n_d = sv.sum(-1), dv.sum(-1)
    k_s = torch.clamp((trim * n_s).int(), 4, N).long()
    k_d = torch.clamp((trim * n_d).int(), 4, M).long()
    inf = torch.tensor(float("inf"), device=src.device)

    def side(d, valid, k):
        d = torch.where(valid, torch.sqrt(d), inf)
        thr = torch.sort(d, dim=-1).values.gather(1, torch.clamp(k - 1, min=0)[:, None])
        return d, (valid & (d <= thr) & torch.isfinite(d)).float()

    def match(T):
        d2 = sq_dist(transform(src, T), dst)
        d2 = torch.where(dv[:, None, :] & sv[:, :, None], d2, inf)
        d2f, nn_f = torch.min(d2, dim=-1)
        d2b, nn_b = torch.min(d2, dim=1)
        df, wf = side(d2f, sv, k_s)
        db, wb = side(d2b, dv, k_d)
        sq = (torch.where(wf > 0, df * df, 0.0).sum(-1)
              + torch.where(wb > 0, db * db, 0.0).sum(-1))
        err = torch.sqrt(sq / torch.clamp(wf.sum(-1) + wb.sum(-1), min=1.0))
        A = torch.cat([src, take(src, nn_b)], dim=1)
        B = torch.cat([take(dst, nn_f), dst], dim=1)
        return A, B, torch.cat([wf, wb], dim=1), err

    T_cur = T_best = init_T.float()
    e_best = torch.full((src.shape[0],), float("inf"), device=src.device)
    for _ in range(iters):
        A, B, w, err = match(T_cur)
        better = err < e_best
        T_best = torch.where(better[:, None, None], T_cur, T_best)
        e_best = torch.where(better, err, e_best)
        T_cur = torch.where((w.sum(-1) >= 4)[:, None, None], kabsch(A, B, w), T_cur)
    T_best = torch.where((match(T_cur)[3] < e_best)[:, None, None], T_cur, T_best)
    return torch.where(((n_s >= 4) & (n_d >= 4))[:, None, None], T_best, init_T.float())


# ---------------------------------------------------------------- PointDSC

class _Dense(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.zeros(o))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BNDense(nn.Module):
    def __init__(self, i, o, relu: bool = True):
        super().__init__()
        self.conv = _Dense(i, o)
        self.bn = nn.BatchNorm1d(o, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        bn = self.bn
        x = (self.conv(x) - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        x = x * bn.weight + bn.bias
        return F.relu(x) if self.relu else x


class NonLocalBlock(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.projection_q, self.projection_k, self.projection_v = (_Dense(C, C)
                                                                   for _ in range(3))
        self.fc1, self.fc2, self.fc3 = BNDense(C, C // 2), BNDense(C // 2, C // 2), _Dense(C // 2, C)
        self.C = C

    def forward(self, feat, attention):
        Q, K, V = self.projection_q(feat), self.projection_k(feat), self.projection_v(feat)
        weight = torch.softmax(attention * (Q @ K.transpose(-1, -2)) / self.C ** 0.5, dim=-1)
        return feat + self.fc3(self.fc2(self.fc1(weight @ V)))


class NonLocalNet(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer0 = _Dense(c["in_dim"], c["num_channels"])
        self.n = c["num_layers"]
        for i in range(self.n):
            self.add_module(f"pointcn_{i}", BNDense(c["num_channels"], c["num_channels"]))
            self.add_module(f"nonlocal_{i}", NonLocalBlock(c["num_channels"]))

    def forward(self, x, compat):
        x = self.layer0(x)
        for i in range(self.n):
            x = getattr(self, f"nonlocal_{i}")(getattr(self, f"pointcn_{i}")(x), compat)
        return x


class PointDSC(nn.Module):
    """Spectral matching with a learned consistency, batched over pairs."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.sigma = nn.Parameter(torch.ones(1))
        self.encoder = NonLocalNet(c)
        self.cls1, self.cls2, self.cls3 = (_Dense(c["num_channels"], 32), _Dense(32, 32),
                                           _Dense(32, 1))

    def forward(self, src, tgt, valid):
        """(T [B, 4, 4], confidence [B, N]): the pose of the seed with the
        most inliers, refined, and the network's inlier confidence (-inf on
        invalid rows)."""
        c = self.c
        N = src.shape[1]
        v = valid.float()
        pos = torch.cat([src, tgt], dim=-1)
        vs = torch.clamp(v.sum(-1, keepdim=True), min=1.0)
        pos = pos - (torch.sum(pos * v[..., None], dim=1) / vs)[:, None]
        sd = torch.sqrt(sq_dist(src, src) + 1e-12)
        td = torch.sqrt(sq_dist(tgt, tgt) + 1e-12)
        compat = torch.clamp(1.0 - (sd - td) ** 2 / c["sigma_d"] ** 2, min=0.0)
        compat = compat * v[:, :, None] * v[:, None, :]
        feats = self.encoder(pos, compat)
        fn = unit(feats)
        conf = self.cls3(F.relu(self.cls2(F.relu(self.cls1(feats)))))[..., 0]
        conf = torch.where(v > 0, conf, torch.full_like(conf, float("-inf")))
        # seeds: parallel non-maximum suppression, then the top by confidence
        relation = (conf[:, :, None] >= conf[:, None, :]) | (sd >= c["nms_radius"])
        masked = torch.where(torch.isfinite(conf), conf, torch.full_like(conf, -1e30))
        seeds = top_k(masked * relation.all(dim=-1).float(), max(int(N * c["ratio"]), 1))[1]
        T_seed, inliers = self._seed_transforms(fn, src, tgt, v, seeds)
        best = torch.argmax(inliers, dim=-1)   # the first seed of the most inliers
        T = T_seed[torch.arange(src.shape[0], device=src.device), best]
        return self._refine(T, src, tgt, v), conf

    def _seed_transforms(self, fn, src, tgt, v, seeds):
        """Per seed: kNN spectral matching and a weighted Kabsch; (poses
        [B, S, 4, 4], inliers [B, S])."""
        c = self.c
        B, N, _ = src.shape
        k = min(c["k"], N - 1)
        d = 2.0 - 2.0 * (fn @ fn.transpose(-1, -2))
        d = d + torch.where(torch.eye(N, dtype=torch.bool, device=src.device), 1e9, 0.0)
        d = d + (1.0 - v[:, None, :]) * 1e9
        knn = take(top_k(-d, k)[1], seeds)
        kf = take(fn, knn)
        feat_M = torch.clamp(1.0 - (1.0 - torch.einsum("bskc,bslc->bskl", kf, kf))
                             / self.sigma[0] ** 2, min=0.0)
        s_k, t_k = take(src, knn), take(tgt, knn)
        spat_M = torch.clamp(1.0 - (torch.sqrt(sq_dist(s_k, s_k) + 1e-12)
                                    - torch.sqrt(sq_dist(t_k, t_k) + 1e-12)) ** 2
                             / c["sigma_d"] ** 2, min=0.0)
        kv = take(v, knn)
        M = feat_M * spat_M * (1.0 - torch.eye(k, device=src.device))
        M = M * kv[..., :, None] * kv[..., None, :]
        w = torch.ones(M.shape[:-1], device=src.device)
        for _ in range(c["num_iterations"]):
            w = torch.einsum("bskl,bsl->bsk", M, w)
            w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-6)
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-6)
        T_seed = kabsch_quat(s_k, t_k, w)
        l2 = torch.linalg.norm(transform(src[:, None], T_seed) - tgt[:, None], dim=-1)
        inl = (l2 < c["inlier_threshold"]).float() * v[:, None]
        return T_seed, inl.sum(-1)

    def _refine(self, T, src, tgt, v):
        th = self.c["inlier_threshold"]
        prev = torch.full(v.shape[:1], -1.0, device=src.device)
        done = torch.zeros(v.shape[:1], dtype=torch.bool, device=src.device)
        for _ in range(self.c["refine_iters"]):
            l2 = torch.linalg.norm(transform(src, T) - tgt, dim=-1)
            inl = (l2 < th).float() * v
            n = inl.sum(-1)
            T_new = kabsch(src, tgt, inl * (1.0 / (1.0 + (l2 / th) ** 2)))
            T = torch.where((done | ~(n >= 3.0))[:, None, None], T, T_new)
            prev, done = n, done | (torch.abs(n - prev) < 1.0)
        return T


def build_pointdsc(cfg: dict, device) -> PointDSC:
    with torch.device(device):
        return PointDSC(cfg["pointdsc"]).eval()
