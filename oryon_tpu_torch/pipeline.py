"""Serving pipeline: forward -> match -> lift -> solve -> refine, batched.

Counterpart of ``make_run_fn`` in ``oryon_tpu/pipeline.py``; its
``build_pipeline`` (jit plus binding the parameters) has no counterpart,
since PyTorch runs eagerly and the module holds its weights.  The JAX
program ``vmap``s the per-pair stages; here every stage takes the whole batch:
matching is one launch of the masked-argmin kernel for all pairs, and the
solvers are batched.  The packed output has the JAX layout, [B, 39] f32:
rel pose (16) | abs pose (16) | n_corrs | det | iou_a | iou_q | fmr |
inlier_rate | feat_ratio.

Randomness: PyTorch cannot reproduce JAX's random streams, so every random
input is drawn in one place, ``draw_noise``, and every stage that uses noise
takes it as an argument.  A test can rebuild the same arrays from JAX keys.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from oryon_tpu_torch.data.pair_batch import PairBatch, PairView
from oryon_tpu_torch.eval.metrics import fmr, mask_iou
from oryon_tpu_torch.geometry.coords import scale_coords, valid_coords
from oryon_tpu_torch.geometry.kabsch import masked_icp, ransac_kabsch
from oryon_tpu_torch.geometry.pcd import lift_pcd_at
from oryon_tpu_torch.models.oryon import OryonModel
from oryon_tpu_torch.models.convert import from_jax_params
from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
from oryon_tpu_torch.ops.matching import MatchParams, nn_correspondences, src_capacity
from oryon_tpu_torch.ops.resize import resize_mask_nearest
from oryon_tpu_torch.ops.sampling import flat_to_yx, masked_select


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mask_source: str = "predicted"      # predicted | oracle | ovseg
    mask_threshold: float = 0.5
    solver: str = "pointdsc"            # pointdsc | ransac
    match: MatchParams = MatchParams()
    ransac_hypotheses: int = 1024
    ransac_match_err: float = 0.001
    icp_refine: bool = False
    icp_points: int = 512
    icp_iters: int = 48
    icp_trim: float = 0.7
    fmr_dist_th: float = 0.2
    fmr_inlier_th: float = 0.05
    signal_inlier_m: float = 0.02


class PipelineOutputs(NamedTuple):
    pred_rel_pose: torch.Tensor    # [B, 4, 4]
    pred_pose: torch.Tensor        # [B, 4, 4]
    n_corrs: torch.Tensor          # [B]
    detection_valid: torch.Tensor  # [B] bool
    iou_a: torch.Tensor
    iou_q: torch.Tensor
    mask_a: torch.Tensor           # [B, FH, FW] uint8
    mask_q: torch.Tensor
    corrs: torch.Tensor            # [B, N, 4] featmap-frame correspondences
    corr_valid: torch.Tensor       # [B, N]
    packed: torch.Tensor           # [B, 39] f32
    fmr: torch.Tensor
    inlier_rate: torch.Tensor
    feat_ratio: torch.Tensor


class Noise(NamedTuple):
    """Every random input of one batch (uniforms in [0, 1))."""
    match_src: torch.Tensor            # [B, FH*FW] source-pixel selection
    match_out: torch.Tensor            # [B, src_cap] in [1e-20, 1): output sample
    ransac: Optional[torch.Tensor]     # [B, hypotheses, 4] (solver "ransac")
    icp_a: Optional[torch.Tensor]      # [B, FH*FW] anchor cloud selection
    icp_q: Optional[torch.Tensor]      # [B, FH*FW] query cloud selection


def draw_noise(generator: torch.Generator, cfg: PipelineConfig, B: int,
               feat_hw: Tuple[int, int], device) -> Noise:
    """Draw one batch's random inputs from ``generator`` (on ``device``)."""
    hw = feat_hw[0] * feat_hw[1]

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    cap = src_capacity(cfg.match, hw)
    return Noise(
        match_src=u(B, hw),
        match_out=torch.clamp(u(B, cap), min=1e-20),
        ransac=u(B, cfg.ransac_hypotheses, 4) if cfg.solver == "ransac" else None,
        icp_a=u(B, hw) if cfg.icp_refine else None,
        icp_q=u(B, hw) if cfg.icp_refine else None,
    )


def _lift_corrs(corrs_yx, corr_valid, depth_a, depth_q, camera_a, camera_q,
                size_a, size_q, feat_hw):
    """Rescale featmap-frame corrs [B, N, 4] to the original frames and lift
    both ends to 3D metres.  Returns (pts_a, pts_q [B, N, 3], valid [B, N])."""
    Ho, Wo = depth_a.shape[1:]
    sa, sq = size_a.float()[:, None], size_q.float()[:, None]
    ca = scale_coords(corrs_yx[..., :2].float(), feat_hw, sa)
    cq = scale_coords(corrs_yx[..., 2:].float(), feat_hw, sq)
    ok = corr_valid & valid_coords(ca, sa) & valid_coords(cq, sq)
    hi = torch.tensor([Ho - 1, Wo - 1], device=ca.device)
    cai = torch.minimum(torch.clamp(ca.int(), min=0), hi)
    cqi = torch.minimum(torch.clamp(cq.int(), min=0), hi)
    pa = lift_pcd_at(depth_a, camera_a, cai) / 1000.0
    pq = lift_pcd_at(depth_q, camera_q, cqi) / 1000.0
    ok = ok & (pa[..., 2] > 0) & (pq[..., 2] > 0)   # zero-depth lifts are invalid
    return pa, pq, ok


def _lift_mask_cloud(noise, mask_f, depth, camera, size, feat_hw, capacity):
    """Fixed-capacity 3D cloud [B, capacity, 3] (metres) from each view's
    featmap-frame mask, with its validity [B, capacity]."""
    Ho, Wo = depth.shape[1:]
    idx, valid = masked_select(mask_f, noise, capacity)
    s = size.float()[:, None]
    c = scale_coords(flat_to_yx(idx, mask_f.shape[-1]).float(), feat_hw, s)
    ok = valid & valid_coords(c, s)
    hi = torch.tensor([Ho - 1, Wo - 1], device=c.device)
    ci = torch.minimum(torch.clamp(c.int(), min=0), hi)
    p = lift_pcd_at(depth, camera, ci) / 1000.0
    return p, ok & (p[..., 2] > 0)


def _icp_refine_pose(noise_a, noise_q, T, n_corrs, mask_a, mask_q, A: PairView,
                     Q: PairView, feat_hw, cfg: PipelineConfig) -> torch.Tensor:
    """Dense trimmed-ICP refinement of the solver poses on the masked depth
    clouds; pairs without a usable solver start (< 4 corrs) keep T."""
    ca, va = _lift_mask_cloud(noise_a, mask_a, A.orig_depth, A.camera, A.size,
                              feat_hw, cfg.icp_points)
    cq, vq = _lift_mask_cloud(noise_q, mask_q, Q.orig_depth, Q.camera, Q.size,
                              feat_hw, cfg.icp_points)
    T_ref = masked_icp(ca, va, cq, vq, T, iters=cfg.icp_iters, trim=cfg.icp_trim)
    return torch.where((n_corrs >= 4)[:, None, None], T_ref, T)


def _pose_from_corrs(noise_ransac, pa, pq, w, cfg: PipelineConfig,
                     pointdsc: Optional[PointDSC]):
    """Register lifted correspondences (``_lift_corrs``) with weights w [B, N].
    Returns (T [B, 4, 4], valid-corr count [B])."""
    if cfg.solver == "ransac":
        T = ransac_kabsch(pa, pq, w, noise_ransac, cfg.ransac_match_err)[0]
    else:
        T = pointdsc(pa, pq, w)[0]
    return T, w.sum(-1)


def make_pipeline_config(cfg, solver: str,
                         mask_source: Optional[str] = None) -> PipelineConfig:
    """PipelineConfig from the config tree (``config.Config``): the one
    place where ``cfg.test.*`` becomes pipeline settings.  ``mask_source``
    overrides ``cfg.test.mask``.  ``cfg.debug_valid`` (ground-truth
    correspondences in place of matching, an evaluation probe) is not part
    of the serving path and raises."""
    if cfg.debug_valid:
        raise NotImplementedError(
            "debug_valid (ground-truth correspondences) belongs to the "
            "evaluation entry point, which is not ported yet")
    return PipelineConfig(
        mask_source=cfg.test.mask if mask_source is None else mask_source,
        mask_threshold=cfg.test.mask_threshold,
        solver=solver,
        match=MatchParams(src_capacity=5120, max_corrs=cfg.test.n_corrs,
                          dist_th=cfg.test.dist_th),
        icp_refine=cfg.test.icp_refine,
        icp_points=cfg.test.icp_points,
        icp_iters=cfg.test.icp_iters,
        icp_trim=cfg.test.icp_trim,
    )


def pointdsc_snapshot_path(pretrained_dir: str) -> str:
    """Where the published PointDSC 3DMatch torch snapshot would lie."""
    return os.path.join(
        pretrained_dir, "snapshot/PointDSC_3DMatch_release/models/model_best.pkl")


def pointdsc_native_path(pretrained_dir: str) -> str:
    """Flax-native PointDSC weights (written by the JAX package's
    ``scripts/train_pointdsc.py``): a flat npz of '/'-joined variable paths
    across all collections."""
    return os.path.join(pretrained_dir, "native.npz")


def pointdsc_weights_available(pretrained_dir: str) -> bool:
    """True when trained PointDSC weights exist in either format: the gate
    of the protocol solver (a random-init network gives noise poses, so
    ``OryonPredictor.from_config`` falls back to RANSAC without them)."""
    return (os.path.exists(pointdsc_native_path(pretrained_dir))
            or os.path.exists(pointdsc_snapshot_path(pretrained_dir)))


def build_pointdsc_solver(pretrained_dir: str) -> PointDSC:
    """The PointDSC module with the trained weights of ``native.npz``,
    bridged by ``from_jax_params``; its depth is read off the tree.  Says
    which file it loaded.  The torch-snapshot converter is not ported: a
    directory that holds only the snapshot raises, and so does one that
    holds neither (no random weights are served)."""
    native = pointdsc_native_path(pretrained_dir)
    if not os.path.exists(native):
        if os.path.exists(pointdsc_snapshot_path(pretrained_dir)):
            raise NotImplementedError(
                "only the PointDSC torch snapshot is present; its converter "
                "is not ported yet (ROADMAP queue 1, checkpoint restore)")
        raise FileNotFoundError(f"no PointDSC weights under {pretrained_dir!r}")
    with np.load(native) as z:
        flat = {tuple(k.split("/")): z[k] for k in z.files}
    variables: dict = {}
    for path, leaf in flat.items():
        node = variables
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    n_layers = len({k[2] for k in flat if k[:2] == ("params", "encoder")
                    and k[2].startswith("pointcn_")})
    pd = PointDSC(PointDSCConfig(num_layers=n_layers))
    pd.load_state_dict(from_jax_params(variables), strict=True)
    print(f"PointDSC weights: {native}")
    return pd.eval()


def make_run_fn(model: OryonModel, cfg: PipelineConfig,
                pointdsc: Optional[PointDSC] = None):
    """The eval program: (PairBatch, text_emb, noise | generator) ->
    PipelineOutputs.  ``noise`` defaults to ``draw_noise(generator, ...)``.
    ``stage_events``, a list, collects (stage name, CUDA event) pairs at the
    stage boundaries for timing on the card."""
    if cfg.solver == "pointdsc" and pointdsc is None:
        raise ValueError("pointdsc solver needs a PointDSC module")
    if cfg.solver not in ("pointdsc", "ransac"):
        raise ValueError(f"solver {cfg.solver!r} not in ('pointdsc', 'ransac')")

    @torch.inference_mode()
    def run(batch: PairBatch, text_emb: Optional[torch.Tensor] = None,
            noise: Optional[Noise] = None,
            generator: Optional[torch.Generator] = None,
            stage_events: Optional[list] = None) -> PipelineOutputs:
        def mark(name):
            if stage_events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                stage_events.append((name, ev))

        A, Q = batch.anchor, batch.query
        mark("start")
        out = model(A.rgb, Q.rgb, batch.prompt_ids, text_emb)
        mark("forward")
        B, FH, FW, _ = out.featmap_a.shape
        if noise is None:
            noise = draw_noise(generator, cfg, B, (FH, FW), out.featmap_a.device)
        pred_mask_a = (torch.sigmoid(out.mask_a) > cfg.mask_threshold).to(torch.uint8)
        pred_mask_q = (torch.sigmoid(out.mask_q) > cfg.mask_threshold).to(torch.uint8)
        gt_a = resize_mask_nearest(A.mask, (FH, FW))
        gt_q = resize_mask_nearest(Q.mask, (FH, FW))
        if cfg.mask_source == "predicted":
            match_a, match_q = pred_mask_a, pred_mask_q
        else:
            match_a, match_q = gt_a, gt_q
        iou_a = mask_iou(gt_a, pred_mask_a)
        iou_q = mask_iou(gt_q, pred_mask_q)
        det_valid = (match_a.sum(dim=(1, 2)) > 0) & (match_q.sum(dim=(1, 2)) > 0)

        corr = nn_correspondences(out.featmap_a, out.featmap_q, match_a, match_q,
                                  noise.match_src, noise.match_out, cfg.match)
        mark("match")
        pa, pq, ok = _lift_corrs(corr.yx, corr.valid, A.orig_depth, Q.orig_depth,
                                 A.camera, Q.camera, A.size, Q.size, (FH, FW))
        w = ok.float()
        T_rel, n_corrs = _pose_from_corrs(noise.ransac, pa, pq, w, cfg, pointdsc)
        mark("solve")
        if cfg.icp_refine:
            T_rel = _icp_refine_pose(noise.icp_a, noise.icp_q, T_rel, n_corrs,
                                     match_a, match_q, A, Q, (FH, FW), cfg)
        mark("icp")

        # learning-signal metrics: FMR at the GT correspondence pixels and
        # the geometric inlier rate of the predicted matches under GT pose
        ih, iw = A.rgb.shape[1:3]
        sig = scale_coords(batch.corrs.float(), (ih, iw), (FH, FW))
        hi = torch.tensor([FH - 1, FW - 1, FH - 1, FW - 1], device=sig.device)
        sig = torch.minimum(torch.clamp(sig, min=0), hi).long()
        bidx = torch.arange(B, device=sig.device)[:, None]
        fmr_v, feat_ratio = fmr(out.featmap_a[bidx, sig[..., 0], sig[..., 1]],
                                out.featmap_q[bidx, sig[..., 2], sig[..., 3]],
                                cfg.fmr_dist_th, cfg.fmr_inlier_th, w=batch.corr_valid)
        rel_gt = (batch.rel_pose if batch.rel_pose is not None
                  else torch.eye(4, device=w.device).expand(B, 4, 4))
        p2 = pa @ rel_gt[:, :3, :3].transpose(1, 2) + rel_gt[:, None, :3, 3]
        dist = torch.linalg.norm(p2 - pq, dim=-1)
        inlier_rate = torch.sum((dist < cfg.signal_inlier_m) * w, dim=-1) / torch.clamp(
            w.sum(-1), min=1.0)

        # pairs without correspondences report identity
        eye = torch.eye(4, device=T_rel.device).expand_as(T_rel)
        T_rel = torch.where((n_corrs >= 4)[:, None, None], T_rel, eye)
        pred_q = T_rel @ A.pose.float()
        packed = torch.cat([
            T_rel.reshape(B, 16), pred_q.reshape(B, 16),
            n_corrs[:, None], det_valid[:, None].float(),
            iou_a[:, None].float(), iou_q[:, None].float(), fmr_v[:, None],
            inlier_rate[:, None], feat_ratio[:, None]], dim=1)
        mark("end")
        return PipelineOutputs(
            pred_rel_pose=T_rel, pred_pose=pred_q, n_corrs=n_corrs,
            detection_valid=det_valid, iou_a=iou_a, iou_q=iou_q,
            mask_a=pred_mask_a, mask_q=pred_mask_q, corrs=corr.yx,
            corr_valid=corr.valid, packed=packed, fmr=fmr_v,
            inlier_rate=inlier_rate, feat_ratio=feat_ratio)

    return run

