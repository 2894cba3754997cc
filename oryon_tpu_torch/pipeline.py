"""Serving pipeline: forward -> match -> lift -> solve -> refine, batched.

Counterpart of ``make_run_fn`` and ``build_pipeline`` in
``oryon_tpu/pipeline.py``; PyTorch runs eagerly and the module holds its
weights, so ``build_pipeline`` only adds the split over several GPUs.  The JAX
program ``vmap``s the per-pair stages; here every stage takes the whole batch:
matching is one launch of the masked-argmin kernel for all pairs, and the
solvers are batched.  The packed output has the JAX layout, [B, 39] f32:
rel pose (16) | abs pose (16) | n_corrs | det | iou_a | iou_q | fmr |
inlier_rate | feat_ratio.

Randomness: PyTorch cannot reproduce JAX's random streams, so every random
input is drawn in one place, ``draw_noise``, and every stage that uses noise
takes it as an argument.  A test can rebuild the same arrays from JAX keys.

Several GPUs: ``build_pipeline(..., mesh=...)`` splits each batch over the
mesh's ``data`` ranks, draws the noise of the global batch on every rank
and keeps the rank's rows, and gathers the outputs, so every rank returns
the single-device result of the global batch.

The evaluation loop is here too: ``run_test_epoch`` drives a batch program
over a dataset and registers every pair with an evaluator, writing the
prediction CSV; ``make_text_cache`` encodes each class's prompts once.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from oryon_tpu_torch.data.pair_batch import PairBatch, PairView
from oryon_tpu_torch.eval.metrics import fmr, mask_iou
from oryon_tpu_torch.geometry.coords import scale_coords, valid_coords
from oryon_tpu_torch.geometry.kabsch import masked_icp, ransac_kabsch
from oryon_tpu_torch.geometry.pcd import lift_pcd_at
from oryon_tpu_torch.models.oryon import OryonModel
from oryon_tpu_torch.models.convert import (convert_pointdsc, from_jax_params,
                                            load_flax_npz, load_torch_state)
from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
from oryon_tpu_torch.ops.matching import MatchParams, nn_correspondences, src_capacity
from oryon_tpu_torch.ops.resize import resize_mask_nearest
from oryon_tpu_torch.ops.sampling import flat_to_yx, masked_select
from oryon_tpu_torch.parallel.mesh import gather_outputs, take_rows
from oryon_tpu_torch.parallel.tp import copy_module
from oryon_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mask_source: str = "predicted"      # predicted | oracle | ovseg
    mask_threshold: float = 0.5
    solver: str = "pointdsc"            # pointdsc | ransac
    match: MatchParams = MatchParams()
    ransac_hypotheses: int = 1024
    ransac_match_err: float = 0.001
    debug_valid: bool = False           # GT corrs -> solver upper bound
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
    with span("icp.clouds"):
        ca, va = _lift_mask_cloud(noise_a, mask_a, A.orig_depth, A.camera, A.size,
                                  feat_hw, cfg.icp_points)
        cq, vq = _lift_mask_cloud(noise_q, mask_q, Q.orig_depth, Q.camera, Q.size,
                                  feat_hw, cfg.icp_points)
    with span("icp.iterate"):
        T_ref = masked_icp(ca, va, cq, vq, T, iters=cfg.icp_iters, trim=cfg.icp_trim)
        return torch.where((n_corrs >= 4)[:, None, None], T_ref, T)


def _featmap_coords(corrs: torch.Tensor, in_hw, feat_hw) -> torch.Tensor:
    """Input-frame (y1, x1, y2, x2) rows [B, N, 4] scaled to the featmap
    frame, clipped into it and truncated to int64."""
    FH, FW = feat_hw
    fc = scale_coords(corrs.float(), in_hw, feat_hw)
    hi = torch.tensor([FH - 1, FW - 1, FH - 1, FW - 1], device=fc.device)
    return torch.minimum(torch.clamp(fc, min=0), hi).long()


def _gt_featmap_corrs(batch: PairBatch, feat_hw, max_corrs: int):
    """The annotated correspondences in the featmap frame, padded with
    invalid rows or cut to ``max_corrs`` (``debug_valid``)."""
    fc = _featmap_coords(batch.corrs, batch.anchor.rgb.shape[1:3], feat_hw)
    valid = batch.corr_valid.bool()
    pad = max_corrs - fc.shape[1]
    if pad > 0:
        return (torch.nn.functional.pad(fc, (0, 0, 0, pad)),
                torch.nn.functional.pad(valid, (0, pad)))
    return fc[:, :max_corrs], valid[:, :max_corrs]


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
    place where ``cfg.test.*`` and ``cfg.debug_valid`` (ground-truth
    correspondences in place of matching, the solver's upper bound) become
    pipeline settings.  ``mask_source`` overrides ``cfg.test.mask``."""
    return PipelineConfig(
        mask_source=cfg.test.mask if mask_source is None else mask_source,
        mask_threshold=cfg.test.mask_threshold,
        solver=solver,
        debug_valid=cfg.debug_valid,
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
    """The PointDSC module with its trained weights.  Prefers the published
    torch snapshot (through ``convert_pointdsc``), then ``native.npz``, whose
    depth is read off the tree; both reach the module through
    ``from_jax_params``.  Says which file it loaded, so that a stale
    ``native.npz`` cannot stand in for the snapshot unnoticed.  A directory
    that holds neither raises: no random weights are served."""
    native = pointdsc_native_path(pretrained_dir)
    snapshot = pointdsc_snapshot_path(pretrained_dir)
    if os.path.exists(snapshot):
        variables = convert_pointdsc(load_torch_state(snapshot))
        print(f"PointDSC weights: reference snapshot {snapshot}")
    elif os.path.exists(native):
        variables = load_flax_npz(native)
        print(f"PointDSC weights: flax-native {native}")
    else:
        raise FileNotFoundError(f"no PointDSC weights under {pretrained_dir!r}")
    n_layers = sum(k.startswith("pointcn_") for k in variables["params"]["encoder"])
    pd = PointDSC(PointDSCConfig(num_layers=n_layers))
    pd.load_state_dict(from_jax_params(variables), strict=True)
    return pd.eval()


def make_run_fn(model: OryonModel, cfg: PipelineConfig,
                pointdsc: Optional[PointDSC] = None):
    """The eval program: (PairBatch, text_emb, noise | generator) ->
    PipelineOutputs.  ``noise`` defaults to ``draw_noise(generator, ...)``;
    with ``rows`` = (global batch size, row indices) the batch is those rows
    of a global batch and the noise is drawn for the global one and cut.
    ``stage_events``, a list, collects (stage name, CUDA event) pairs at the
    stage boundaries for timing on the card: the device side of the host
    spans ``pipeline.forward``, ``.match``, ``.solve``, ``.icp`` and ``.pack``
    (``utils.profiling.span``), which hold the stages' host work."""
    if cfg.solver == "pointdsc" and pointdsc is None:
        raise ValueError("pointdsc solver needs a PointDSC module")
    if cfg.solver not in ("pointdsc", "ransac"):
        raise ValueError(f"solver {cfg.solver!r} not in ('pointdsc', 'ransac')")

    @torch.inference_mode()
    def run(batch: PairBatch, text_emb: Optional[torch.Tensor] = None,
            noise: Optional[Noise] = None,
            generator: Optional[torch.Generator] = None,
            stage_events: Optional[list] = None,
            rows: Optional[Tuple[int, np.ndarray]] = None) -> PipelineOutputs:
        def mark(name):
            if stage_events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                stage_events.append((name, ev))

        A, Q = batch.anchor, batch.query
        mark("start")
        with span("pipeline.forward"):
            out = model(A.rgb, Q.rgb, batch.prompt_ids, text_emb)
        mark("forward")
        with span("pipeline.match"):
            B, FH, FW, _ = out.featmap_a.shape
            if noise is None and rows is None:
                noise = draw_noise(generator, cfg, B, (FH, FW), out.featmap_a.device)
            elif noise is None:
                # ``batch`` is rows ``rows[1]`` of a global batch of ``rows[0]``:
                # the global batch's draws, cut to them
                noise = take_rows(draw_noise(generator, cfg, rows[0], (FH, FW),
                                             out.featmap_a.device), rows[1], rows[0])
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

            if cfg.debug_valid:
                corrs_yx, corr_valid = _gt_featmap_corrs(batch, (FH, FW), cfg.match.max_corrs)
            else:
                corr = nn_correspondences(out.featmap_a, out.featmap_q, match_a, match_q,
                                          noise.match_src, noise.match_out, cfg.match)
                corrs_yx, corr_valid = corr.yx, corr.valid
        mark("match")
        with span("pipeline.solve"):
            with span("solve.lift"):
                pa, pq, ok = _lift_corrs(corrs_yx, corr_valid, A.orig_depth, Q.orig_depth,
                                         A.camera, Q.camera, A.size, Q.size, (FH, FW))
                w = ok.float()
            T_rel, n_corrs = _pose_from_corrs(noise.ransac, pa, pq, w, cfg, pointdsc)
        mark("solve")
        if cfg.icp_refine:
            with span("pipeline.icp"):
                T_rel = _icp_refine_pose(noise.icp_a, noise.icp_q, T_rel, n_corrs,
                                         match_a, match_q, A, Q, (FH, FW), cfg)
        mark("icp")

        with span("pipeline.pack"):
            # learning-signal metrics: FMR at the GT correspondence pixels and
            # the geometric inlier rate of the predicted matches under GT pose
            sig = _featmap_coords(batch.corrs, A.rgb.shape[1:3], (FH, FW))
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
            mask_a=pred_mask_a, mask_q=pred_mask_q, corrs=corrs_yx,
            corr_valid=corr_valid, packed=packed, fmr=fmr_v,
            inlier_rate=inlier_rate, feat_ratio=feat_ratio)

    return run


def build_pipeline(model: OryonModel, cfg: PipelineConfig,
                   pointdsc: Optional[PointDSC] = None, mesh=None):
    """The eval program of ``make_run_fn``, split over the ``data`` ranks of
    ``mesh`` (the counterpart of ``oryon_tpu.pipeline.build_pipeline``).
    Every rank calls it with the same global batch (and ``text_emb``, noise
    or generator); each runs its rows and every rank returns the gathered
    outputs of the whole batch.  Inference has no cross-pair state, so this
    is the single-device result.  ``mesh=None`` returns ``make_run_fn``'s
    program."""
    return split_over_data(make_run_fn(model, cfg, pointdsc), mesh)


def split_over_data(run, mesh):
    """``run`` (a ``make_run_fn`` program) over the data ranks of ``mesh``,
    as ``build_pipeline`` describes; ``run`` itself when ``mesh`` is None."""
    if mesh is None:
        return run

    def wrapped(batch: PairBatch, text_emb: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None,
                generator: Optional[torch.Generator] = None,
                stage_events: Optional[list] = None) -> PipelineOutputs:
        B = batch.corrs.shape[0]
        rows = mesh.batch_rows(B)
        out = run(take_rows(batch, rows, B), take_rows(text_emb, rows, B),
                  take_rows(noise, rows, B), generator, stage_events, rows=(B, rows))
        return gather_outputs(out, mesh)

    return wrapped


def _viz_tracked(viz_dir, dataset, batch: PairBatch, out: PipelineOutputs):
    """Render the tracked pairs of a batch (masks and correspondences)."""
    from oryon_tpu_torch.utils import viz

    tracked = getattr(dataset, "tracked_instances", None)
    if not tracked:
        return
    FH, FW = out.mask_a.shape[1:3]
    for i, iid in enumerate(batch.instance_id):
        if str(iid) not in tracked:
            continue
        rgb_a = batch.anchor.rgb[i].cpu().numpy()
        rgb_q = batch.query.rgb[i].cpu().numpy()
        if rgb_a.dtype == np.uint8:
            rgb_a = rgb_a.astype(np.float32) / 255.0
            rgb_q = rgb_q.astype(np.float32) / 255.0
        gt_a = resize_mask_nearest(batch.anchor.mask[i:i + 1], (FH, FW))[0].cpu().numpy()
        gt_q = resize_mask_nearest(batch.query.mask[i:i + 1], (FH, FW))[0].cpu().numpy()
        base = os.path.join(viz_dir, str(iid).replace(" ", "_"))
        viz.pred_mask(rgb_a, rgb_q, gt_a, gt_q, out.mask_a[i].cpu().numpy(),
                      out.mask_q[i].cpu().numpy(), base + "_mask.png")
        ih, iw = rgb_a.shape[:2]
        rows = out.corrs[i].cpu().numpy().astype(np.float64)
        rows[:, 0] *= ih / FH
        rows[:, 1] *= iw / FW
        rows[:, 2] *= ih / FH
        rows[:, 3] *= iw / FW
        viz.corr_set(rgb_a, rgb_q, rows, out.corr_valid[i].cpu().numpy(),
                     base + "_corrs.png")


def make_text_cache(model: OryonModel):
    """Per-class prompt-embedding cache: each distinct class's prompts are
    encoded once and reused across the sweep.  Returns get(cls_ids,
    prompt_ids [B, P, L]) -> [B, P, D]."""
    cache: Dict[str, torch.Tensor] = {}

    def get(cls_ids, prompt_ids: torch.Tensor) -> torch.Tensor:
        rows = []
        for i, c in enumerate(cls_ids):
            k = str(c)
            if k not in cache:
                with torch.inference_mode():
                    cache[k] = model.encode_prompts(prompt_ids[i: i + 1])[0]
            rows.append(cache[k])
        return torch.stack(rows)

    return get


TRAIN_TEXT_CACHE_ENTRIES = 4096   # about 1 GB of [80, 768] f32 rows


def make_train_text_cache(model: OryonModel):
    """Prompt-embedding cache for training, keyed by the token bytes of a
    pair's prompt set (synset and template augmentation vary the prompts
    from pair to pair).  Returns get(prompt_ids [B, P, L], a tensor or a
    host array) -> [B, P, D] on the text tower's device.

    Misses are encoded together in one [B, P, L] batch (the first row
    repeated as filler); beyond ``TRAIN_TEXT_CACHE_ENTRIES`` entries leave
    first in, first out.  It encodes with a private copy of the text tower, which
    training never changes (the tower is frozen)."""
    tower = copy_module(model.vlm_text).eval()
    for p in tower.parameters():
        p.requires_grad_(False)
    device = next(tower.parameters()).device
    cache: Dict[bytes, torch.Tensor] = {}

    def get(prompt_ids) -> torch.Tensor:
        ids_np = (prompt_ids.cpu().numpy() if isinstance(prompt_ids, torch.Tensor)
                  else np.asarray(prompt_ids))
        B, P, L = ids_np.shape
        keys = [ids_np[i].tobytes() for i in range(B)]
        miss: Dict[bytes, int] = {}
        for i, k in enumerate(keys):
            if k not in cache and k not in miss:
                miss[k] = i
        if miss:
            mk = list(miss)
            arr = np.repeat(ids_np[:1], B, axis=0)
            arr[: len(mk)] = ids_np[[miss[k] for k in mk]]
            ids = torch.as_tensor(arr, device=device)
            with torch.no_grad():
                embs = tower(ids.reshape(B * P, L)).reshape(B, P, -1)
            for j, k in enumerate(mk):
                cache[k] = embs[j]
        # gather before evicting: eviction may drop keys this batch holds
        rows = torch.stack([cache[k] for k in keys])
        while len(cache) > TRAIN_TEXT_CACHE_ENTRIES:
            cache.pop(next(iter(cache)))
        return rows

    return get


def run_test_epoch(pipeline_fn, dataset, evaluator, batch_size: int, csv_fp=None,
                   compute_vsd: bool = True, text_cache=None, save_hook=None,
                   viz_dir=None, loader=None, drain_lookahead: int = 3,
                   step_profiler=None, score: bool = True) -> int:
    """Run ``pipeline_fn(batch, text_emb) -> PipelineOutputs`` over every
    batch and register each pair with ``evaluator``; returns the number of
    pairs registered (pads excluded).

    ``loader``: an iterable of batches (``data.loader.PrefetchLoader``),
    else the dataset's own ``batches`` grouped by class.  The calling thread
    only dispatches batches; a drain thread does the per-batch work that
    waits for the device (the one fetch of the packed [B, 39] outputs, the
    save and viz hooks, the CSV lines, the evaluator's scoring), behind a
    queue of ``drain_lookahead`` batches.  The order is first in, first out,
    so CSV rows and registrations come in the serial loop's order.  An error
    in the drain thread stops the dispatch and is raised on the caller's
    thread.

    ``score=False`` dispatches every batch and registers none (returns 0):
    the ranks other than 0 of a ``build_pipeline`` program over a mesh,
    which take part in each batch's collectives while rank 0 scores."""
    import queue as _queue
    import threading

    def dispatch(batch):
        text_emb = (text_cache(batch.cls_id, batch.prompt_ids)
                    if text_cache is not None else None)
        return pipeline_fn(batch, text_emb)

    it = iter(loader if loader is not None
              else dataset.batches(batch_size, sort_by_class=True))
    state = {"n": 0, "err": None}
    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, drain_lookahead))

    def drain():
        with torch.inference_mode():
            while True:
                item = q.get()
                if item is None:
                    return
                if state["err"] is not None:
                    continue  # keep unblocking the producer until the sentinel
                bi, batch, out = item
                if not score:
                    continue
                try:
                    if save_hook is not None:
                        save_hook(bi, batch, out)
                    if viz_dir is not None:
                        _viz_tracked(viz_dir, dataset, batch, out)
                    state["n"] += _register_batch(evaluator, batch, out, csv_fp,
                                                  compute_vsd)
                except BaseException as e:  # raised again on the caller's thread
                    state["err"] = e

    t = threading.Thread(target=drain, daemon=True, name="oryon-test-drain")
    t.start()
    try:
        with torch.inference_mode():
            for bi, nxt in enumerate(it):
                if state["err"] is not None:
                    break
                q.put((bi, nxt, dispatch(nxt)))
                if step_profiler is not None:
                    step_profiler.step()
    finally:
        q.put(None)
        t.join()
        if step_profiler is not None:
            step_profiler.close()
    if state["err"] is not None:
        raise state["err"]
    return state["n"]


def _register_batch(evaluator, batch: PairBatch, out: PipelineOutputs, csv_fp,
                    compute_vsd: bool) -> int:
    """Register one batch's pairs (pads skipped) and write their CSV lines."""
    from oryon_tpu_torch.eval.evaluator import pred_pose_csv_line

    B = batch.corrs.shape[0]
    packed = out.packed.cpu().numpy()     # the one fetch of the batch's scalars
    pred_rel = packed[:, :16].reshape(B, 4, 4)
    pred_q = packed[:, 16:32].reshape(B, 4, 4)
    n_corrs = packed[:, 32]
    det = packed[:, 33] > 0
    iou_a, iou_q = packed[:, 34], packed[:, 35]
    fmr_v, inl_v, ratio_v = packed[:, 36], packed[:, 37], packed[:, 38]
    valid = np.asarray(batch.valid)
    gt_pose_q = batch.query.pose.cpu().numpy()
    cameras = batch.query.camera.cpu().numpy().reshape(B, 3, 3)
    # the scene depths stay on the device: the batched evaluator picks and
    # casts its rows there
    depths_dev = batch.query.eval_depth
    depths = None

    batched = hasattr(evaluator, "register_test_batch")
    ok_idx = [i for i in range(B) if valid[i] != 0 and det[i] and n_corrs[i] >= 4]
    if batched and ok_idx:
        sel = np.asarray(ok_idx)
        evaluator.register_test_batch(
            iou_a[sel], iou_q[sel], gt_pose_q[sel], pred_q[sel], pred_rel[sel],
            [batch.cls_id[i] for i in ok_idx], cameras[sel],
            depths_dev if compute_vsd else None,
            [batch.instance_id[i] for i in ok_idx], depth_index=sel)
    # learning-signal metrics for every live pair, detected or not
    if hasattr(evaluator, "register_signal") and "FMR" in evaluator.metrics:
        live = [i for i in range(B) if valid[i] != 0]
        if live:
            evaluator.register_signal(fmr_v[live], inl_v[live], ratio_v[live])
    n_registered = 0
    for i in range(B):
        if valid[i] == 0:  # padding rows
            continue
        n_registered += 1
        if det[i] and n_corrs[i] >= 4:
            if not batched:
                if depths is None and compute_vsd:
                    depths = depths_dev.cpu().numpy()
                evaluator.register_test(
                    iou_a[i], iou_q[i], gt_pose=gt_pose_q[i], pred_pose=pred_q[i],
                    pred_pose_rel=pred_rel[i], camera=cameras[i],
                    depth=depths[i] if compute_vsd else None,
                    cls_id=batch.cls_id[i], instance_id=batch.instance_id[i])
            pose_out = pred_rel[i]
        else:
            evaluator.register_test_failure(iou_a[i], iou_q[i], cls_id=batch.cls_id[i],
                                            instance_id=batch.instance_id[i])
            pose_out = np.eye(4)
        if csv_fp is not None:
            ia = batch.id_a[i] if batch.id_a is not None else batch.instance_id[i]
            iq = batch.id_q[i] if batch.id_q is not None else batch.instance_id[i]
            csv_fp.write(pred_pose_csv_line(str(ia), str(iq), float(iou_a[i]),
                                            float(iou_q[i]), pose_out))
    return n_registered
