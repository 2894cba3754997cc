"""PointDSC registration (spectral matching + weighted Kabsch).

Counterpart of ``oryon_tpu/models/pointdsc.py``, batched over pairs (the
JAX package ``vmap``s one pair at a time): spatial-consistency matrix,
NonLocalNet (PointCN layers with SC-modulated attention), confidence head,
parallel NMS seeds, per-seed kNN spectral matching with power iteration,
quaternion Kabsch per seed, selection by inlier fitness and fixed-trip
post-refinement.  Invalid rows are excluded everywhere, as there.  All f32.

``forward(..., train=True)`` is the training mode of the port's
``scripts/train_pointdsc.py``: BatchNorm normalises each problem (pair) by
its own statistics over its N rows, padded rows included, as the JAX
package's per-problem ``vmap`` does, and the running statistics move by
flax's rule (momentum 0.99, biased variance), averaged over the problems.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from oryon_tpu_torch.geometry.kabsch import (_take, weighted_kabsch,
                                             weighted_kabsch_quat)
from oryon_tpu_torch.geometry.pcd import sq_dist_matrix, transform_pcd, unit
from oryon_tpu_torch.models.layers import Dense
from oryon_tpu_torch.ops.sampling import top_k
from oryon_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PointDSCConfig:
    in_dim: int = 6
    num_layers: int = 6
    num_channels: int = 128
    num_iterations: int = 10     # power-iteration trips
    ratio: float = 0.1           # seed fraction
    inlier_threshold: float = 0.10
    sigma_d: float = 0.10
    k: int = 40                  # kNN neighbourhood
    nms_radius: float = 0.10
    refine_iters: int = 20


BN_MOMENTUM = 0.99    # flax's: running = momentum * running + (1 - momentum) * batch


class BNDense(nn.Module):
    """Dense + BatchNorm + optional ReLU.  Eval mode normalises by the
    running statistics; ``train=True`` by each problem's own (x [B, N, C]:
    statistics over N), and updates the running ones."""

    def __init__(self, in_dim: int, out_dim: int, relu: bool = True):
        super().__init__()
        self.conv = Dense(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim, eps=1e-5)
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if train:
            x = self._per_problem_norm(x)
        else:
            shape = x.shape
            x = F.batch_norm(x.reshape(-1, shape[-1]), self.bn.running_mean,
                             self.bn.running_var, self.bn.weight, self.bn.bias, False, 0.0,
                             self.bn.eps).reshape(shape)
        return F.relu(x) if self.relu else x

    def _per_problem_norm(self, x: torch.Tensor) -> torch.Tensor:
        """flax's BatchNorm over the rows of each problem: the variance as
        E[x^2] - E[x]^2 clipped at 0 (biased), y = (x - mean) * (scale *
        rsqrt(var + eps)) + bias."""
        bn = self.bn
        mean = x.mean(dim=1)
        var = torch.clamp((x * x).mean(dim=1) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        with torch.no_grad():
            for run, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                run.copy_((BN_MOMENTUM * run + (1.0 - BN_MOMENTUM) * batch.detach()).mean(0))
        return (x - mean[:, None]) * mul[:, None] + bn.bias


class NonLocalBlock(nn.Module):
    def __init__(self, channels: int = 128):
        super().__init__()
        C = channels
        self.projection_q = Dense(C, C)
        self.projection_k = Dense(C, C)
        self.projection_v = Dense(C, C)
        self.fc1 = BNDense(C, C // 2)
        self.fc2 = BNDense(C // 2, C // 2)
        self.fc3 = Dense(C // 2, C)
        self.channels = C

    def forward(self, feat: torch.Tensor, attention: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """feat [B, N, C]; attention [B, N, N] spatial-consistency matrix."""
        Q, K, V = self.projection_q(feat), self.projection_k(feat), self.projection_v(feat)
        feat_attn = (Q @ K.transpose(-1, -2)) / (self.channels ** 0.5)
        weight = torch.softmax(attention * feat_attn, dim=-1)
        return feat + self.fc3(self.fc2(self.fc1(weight @ V, train), train))


class NonLocalNet(nn.Module):
    def __init__(self, cfg: PointDSCConfig):
        super().__init__()
        self.layer0 = Dense(cfg.in_dim, cfg.num_channels)
        for i in range(cfg.num_layers):
            self.add_module(f"pointcn_{i}", BNDense(cfg.num_channels, cfg.num_channels))
            self.add_module(f"nonlocal_{i}", NonLocalBlock(cfg.num_channels))
        self.num_layers = cfg.num_layers

    def forward(self, corr_feat: torch.Tensor, compat: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        feat = self.layer0(corr_feat)
        for i in range(self.num_layers):
            feat = getattr(self, f"pointcn_{i}")(feat, train)
            feat = getattr(self, f"nonlocal_{i}")(feat, compat, train)
        return feat


def pick_seeds(dists: torch.Tensor, scores: torch.Tensor, radius: float,
               max_num: int) -> torch.Tensor:
    """Parallel NMS: a point is a local max if nothing within ``radius``
    outscores it; the top ``max_num`` by score (non-maxima score 0)."""
    relation = (scores[:, :, None] >= scores[:, None, :]) | (dists >= radius)
    is_local_max = relation.all(dim=-1).float()
    masked = torch.where(torch.isfinite(scores), scores,
                         torch.full_like(scores, -1e30)) * is_local_max
    return top_k(masked, max_num)[1]


def seed_transforms(fn, src, tgt, v, seeds, sigma, cfg: PointDSCConfig):
    """Per-seed kNN spectral matching + weighted Kabsch; best by fitness."""
    Bp, N, _ = src.shape
    k = min(cfg.k, N - 1)
    eye = torch.eye(N, dtype=torch.bool, device=src.device)
    d = 2.0 - 2.0 * (fn @ fn.transpose(-1, -2))
    d = d + torch.where(eye, 1e9, 0.0)
    d = d + (1.0 - v[:, None, :]) * 1e9
    knn_idx = _take(top_k(-d, k)[1], seeds)           # [B, S, k]
    kf = _take(fn, knn_idx)                           # [B, S, k, C]
    feat_M = torch.clamp(
        1.0 - (1.0 - torch.einsum("bskc,bslc->bskl", kf, kf)) / sigma ** 2, min=0.0)
    src_knn = _take(src, knn_idx)                     # [B, S, k, 3]
    tgt_knn = _take(tgt, knn_idx)
    sd = torch.sqrt(sq_dist_matrix(src_knn, src_knn) + 1e-12)
    td = torch.sqrt(sq_dist_matrix(tgt_knn, tgt_knn) + 1e-12)
    spat_M = torch.clamp(1.0 - (sd - td) ** 2 / cfg.sigma_d ** 2, min=0.0)
    M = feat_M * spat_M * (1.0 - torch.eye(k, device=src.device))
    # padded rows forced into a neighbourhood must not form a clique
    kv = _take(v, knn_idx)
    M = M * kv[..., :, None] * kv[..., None, :]
    w = torch.ones(M.shape[:-1], device=src.device)
    for _ in range(cfg.num_iterations):
        w = torch.einsum("bskl,bsl->bsk", M, w)
        w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-6)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-6)
    T_seed = weighted_kabsch_quat(src_knn, tgt_knn, w)          # [B, S, 4, 4]
    pred = transform_pcd(src[:, None], T_seed[..., :3, :3], T_seed[..., :3, 3])
    l2 = torch.linalg.norm(pred - tgt[:, None], dim=-1)          # [B, S, N]
    inl = (l2 < cfg.inlier_threshold).float() * v[:, None]
    fitness = inl.sum(-1) / torch.clamp(v.sum(-1, keepdim=True), min=1.0)
    best = torch.argmax(fitness, dim=-1)
    rows = torch.arange(Bp, device=src.device)
    return T_seed[rows, best], inl[rows, best]


def post_refinement(T, src, tgt, v, cfg: PointDSCConfig):
    """Fixed-trip iteratively reweighted refinement with a freeze mask."""
    th = cfg.inlier_threshold
    prev_n = torch.full(v.shape[:1], -1.0, device=src.device)
    done = torch.zeros(v.shape[:1], dtype=torch.bool, device=src.device)
    for _ in range(cfg.refine_iters):
        l2 = torch.linalg.norm(transform_pcd(src, T[:, :3, :3], T[:, :3, 3]) - tgt, dim=-1)
        inlier = (l2 < th).float() * v
        n = inlier.sum(-1)
        stable = torch.abs(n - prev_n) < 1.0
        T_new = weighted_kabsch(src, tgt, inlier * (1.0 / (1.0 + (l2 / th) ** 2)))
        keep = done | ~(n >= 3.0)
        T = torch.where(keep[:, None, None], T, T_new)
        prev_n, done = n, done | stable
    return T


class PointDSC(nn.Module):
    def __init__(self, cfg: PointDSCConfig = PointDSCConfig()):
        super().__init__()
        self.cfg = cfg
        self.sigma = nn.Parameter(torch.ones(1))
        self.encoder = NonLocalNet(cfg)
        self.cls1 = Dense(cfg.num_channels, 32)
        self.cls2 = Dense(32, 32)
        self.cls3 = Dense(32, 1)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                train: bool = False):
        """src/tgt [B, N, 3] matched points (metres); valid [B, N] 0/1.
        Returns (T [B, 4, 4], inlier labels [B, N], confidence [B, N]).

        ``train=True`` returns the two training taps instead: the confidence
        logits [B, N] before the validity mask, and the unit features
        [B, N, C]; BatchNorm then runs on each problem's statistics."""
        c = self.cfg
        N = src.shape[1]
        with span("pointdsc.encoder"):
            src, tgt = src.float(), tgt.float()
            v = valid.float()
            corr_pos = torch.cat([src, tgt], dim=-1)
            vsum = torch.clamp(v.sum(-1, keepdim=True), min=1.0)
            corr_pos = corr_pos - (torch.sum(corr_pos * v[..., None], dim=1) / vsum)[:, None]
            src_dist = torch.sqrt(sq_dist_matrix(src, src) + 1e-12)
            tgt_dist = torch.sqrt(sq_dist_matrix(tgt, tgt) + 1e-12)
            compat = torch.clamp(1.0 - (src_dist - tgt_dist) ** 2 / c.sigma_d ** 2, min=0.0)
            compat = compat * v[:, :, None] * v[:, None, :]

            feats = self.encoder(corr_pos, compat, train)
            fn = unit(feats)
            h = F.relu(self.cls2(F.relu(self.cls1(feats))))
            confidence = self.cls3(h)[..., 0]
        if train:
            return confidence, fn
        with span("pointdsc.seeds"):
            confidence = torch.where(v > 0, confidence,
                                     torch.full_like(confidence, float("-inf")))
            seeds = pick_seeds(src_dist, confidence, c.nms_radius, max(int(N * c.ratio), 1))
            T, _ = seed_transforms(fn, src, tgt, v, seeds, self.sigma[0], c)
        with span("pointdsc.refine"):
            T = post_refinement(T, src, tgt, v, c)
            warped = transform_pcd(src, T[:, :3, :3], T[:, :3, 3])
            labels = (torch.linalg.norm(warped - tgt, dim=-1) < c.inlier_threshold).float() * v
        return T, labels, confidence


def get_pointdsc_pose(model: PointDSC, src: torch.Tensor, tgt: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pair: src/tgt [N, 3], valid [N] (default all rows) -> T [4, 4]."""
    if valid is None:
        valid = torch.ones(src.shape[0], device=src.device)
    with torch.inference_mode():
        return model(src[None], tgt[None], valid[None])[0][0]


def batched_pointdsc(model: PointDSC):
    """The solver over [B, N, 3] correspondence batches: (src, tgt, valid)
    -> (T, inlier labels, confidence).  The module is batched already; this
    is the JAX package's entry point, in inference mode."""
    def run(src, tgt, valid):
        with torch.inference_mode():
            return model(src, tgt, valid)

    return run
