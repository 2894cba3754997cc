"""The comparison that decides ``correct`` for a served cell.

What the timed path produced for a sample of its requests (drawn from the
seed) is held against ``perfbench/reference/``, stage by stage:

- ``input_mismatch``: bytes of the engine's resized views that differ from
  the reference's resize of the raw frames (PIL bilinear, exact);
- ``clip_err``, ``swin_err``, ``text_err``, ``feat_err``, ``mask_err``:
  each stage of the model against the reference's on the served state
  before it (the towers on the resized views, the text tower on the prompt
  ids, fusion and decoder on the served tower outputs), as the relative L2
  error of the worst image or view (the mask logits: of all the request's
  maps together);
- ``mask_mismatch``: pixels of the served masks that do not follow the
  served logits by the threshold;
- ``match_gap``: over every served correspondence, how far its target's
  cosine distance lies above the reference's best target for that source
  (or above the distance limit), both in f32 on the served feature maps and
  masks, with the sources the reference selects from the same draws
  (a source the reference does not select reads as infinite);
- ``match_set_errors``: served correspondences missing from, or extra to,
  the set that the selection rule gives on the reference's distances: the
  sources kept whose best distance lies under ``dist_th``, then the
  ``n_corrs`` of them that the output draws rank first.  A source whose
  reference distance lies within ``SELECTION_BAND`` of ``dist_th`` may be
  in or out (K2's bf16 products move a distance by at most half of it);
  every other is held exactly;
- ``pointdsc_conf_err``: PointDSC's inlier confidence (its network: the
  spatial-consistency matrix, the non-local layers, the head) against the
  reference's on the served correspondences, lifted again by the
  reference; relative L2 over the valid rows of the worst pair.  Its pose
  is not compared: the seed choice and the refinement turn on points that
  lie at the 0.1 m inlier threshold to within rounding, and a flip moves
  the pose by as much as a lower precision does;
- ``icp_gap_mm``: the served final pose against the reference's ICP started
  from the served PointDSC pose.

A pose gap is the largest displacement, in mm, between the two poses of the
corners of a 0.2 m cube 0.7 m in front of the camera.  The reference follows
the served stages from the served state (feature maps, masks,
correspondences, PointDSC pose) after checking the start of each stage
against its own: a fault in one stage shows in that stage's number.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# twice the most that K2's bf16 inputs move a cosine distance of unit
# vectors: 0.5 * (2 * 2^-9 + 2^-18) * sum |a_i b_i| <= 2^-9
SELECTION_BAND = 2.0 ** -8

CUBE = np.array([[x, y, 0.7 + z] for x in (-0.1, 0.1) for y in (-0.1, 0.1)
                 for z in (-0.1, 0.1)], np.float32)


def resize_u8(img: np.ndarray, hw) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((hw[1], hw[0]), Image.BILINEAR))


def pose_gap_mm(T1, T2):
    """[B] largest displacement (mm) of the cube's corners between two poses."""
    import torch
    p = torch.as_tensor(CUBE, device=T1.device)
    a = torch.einsum("bij,nj->bni", T1[:, :3, :3].float(), p) + T1[:, None, :3, 3]
    b = torch.einsum("bij,nj->bni", T2[:, :3, :3].float(), p) + T2[:, None, :3, 3]
    return torch.linalg.norm(a - b, dim=-1).amax(dim=-1) * 1000.0


def _rel(a, b) -> float:
    import torch
    return float(torch.linalg.norm((a.float() - b.float()).flatten())
                 / torch.clamp(torch.linalg.norm(b.float().flatten()), min=1e-30))


def model_numbers(ref_model, sample: Dict, ids, img_hw) -> Dict[str, float]:
    """input_mismatch, and the model's stages each from the served state
    before it: clip_err, swin_err (the towers on the engine's resized
    views), text_err (the text tower on the prompt ids), feat_err and
    mask_err (fusion and decoder on the served tower outputs and prompt
    embeddings); each the relative L2 error of the worst image or view, the
    mask logits' over all the request's maps together."""
    import torch
    dev = sample["featmap_a"].device
    reqs = sample["requests"]
    rgb = {s: torch.as_tensor(np.stack([resize_u8(r[s]["rgb"], img_hw) for r in reqs]),
                              device=dev) for s in ("anchor", "query")}
    mismatch = int((rgb["anchor"] != sample["rgb_a"]).sum() + (rgb["query"] != sample["rgb_q"]).sum())
    rgb2 = torch.cat([rgb["anchor"], rgb["query"]])
    with torch.no_grad():
        visual = ref_model.clip_tower(rgb2)
        guid = ref_model.swin_tower(rgb2)
        text = ref_model.encode_prompts(ids)
        out = ref_model.head(sample["visual"], sample["guid"], sample["text"])
    n = rgb2.shape[0]
    return {"input_mismatch": mismatch,
            "clip_err": max(_rel(sample["visual"][i], visual[i]) for i in range(n)),
            "swin_err": max(_rel(sample["guid"][t][i], guid[t][i]) for t in range(len(guid))
                            for i in range(n)),
            "text_err": max(_rel(sample["text"][i], text[i]) for i in range(len(reqs))),
            "feat_err": max(_rel(sample[k][i], getattr(out, k)[i])
                            for k in ("featmap_a", "featmap_q") for i in range(len(reqs))),
            # pooled over the request's maps: a single map's logits can lie near
            # zero, and its relative error then swings from seed to seed
            "mask_err": _rel(torch.stack([sample["mask_a"], sample["mask_q"]]),
                             torch.stack([out.mask_a, out.mask_q]))}


def pose_numbers(pose, ref_pdsc, sample: Dict, noise, pipe: Dict) -> Dict[str, float]:
    """mask_mismatch, match_gap, match_set_errors, pointdsc_conf_err and
    icp_gap_mm of one captured request, from its served state."""
    import torch
    fa, fq = sample["featmap_a"].float(), sample["featmap_q"].float()
    B, FH, FW, _ = fa.shape
    thr = pipe["mask_threshold"]
    ma = (torch.sigmoid(sample["mask_a"]) > thr).to(torch.uint8)
    mq = (torch.sigmoid(sample["mask_q"]) > thr).to(torch.uint8)
    mask_mismatch = int((ma != sample["out_mask_a"]).sum() + (mq != sample["out_mask_q"]).sum())
    cap = min(pipe["src_capacity"], FH * FW)
    src_idx, src_valid = pose.masked_select(ma, noise.match_src, cap)
    rows, valid = sample["corrs"], sample["corr_valid"].bool()
    gap, set_errors = 0.0, 0
    for b in range(B):
        d = pose.source_distances(fa[b:b + 1], fq[b:b + 1], src_idx[b:b + 1], mq[b:b + 1])[0]
        min_d = d.min(dim=-1).values
        slot = torch.full((FH * FW,), -1, dtype=torch.long, device=fa.device)
        ok = src_valid[b]
        slot[src_idx[b][ok]] = torch.nonzero(ok).flatten()
        r = rows[b][valid[b]]
        j = slot[r[:, 0] * FW + r[:, 1]]
        set_errors += selection_errors(j, ok, min_d, noise.match_out[b], pipe)
        if bool((j < 0).any()):
            gap = float("inf")
        elif len(j):
            dj = d[j, r[:, 2] * FW + r[:, 3]]
            g = torch.maximum(dj - min_d[j], dj - pipe["dist_th"]).max()
            gap = max(gap, float(g))
    with torch.no_grad():
        _, conf, T_icp = solve(pose, ref_pdsc, sample, noise, pipe, ma, mq)
    served = sample["pointdsc_conf"]
    live = torch.isfinite(conf)
    if not bool((live == torch.isfinite(served)).all()):
        conf_err = float("inf")     # the served rows' validity differs
    else:
        conf_err = max(_rel(served[b][live[b]], conf[b][live[b]]) for b in range(B))
    return {"mask_mismatch": mask_mismatch, "match_gap": gap, "match_set_errors": set_errors,
            "pointdsc_conf_err": conf_err,
            "icp_gap_mm": float(pose_gap_mm(sample["pose"], T_icp).max())}


def selection_errors(j, src_valid, min_d, noise_out, pipe: Dict) -> int:
    """Served rows of one pair that the selection rule does not give, plus
    rows that it gives and the pair lacks.  ``j``: the source slot of each
    served valid row (-1 where the source is not one the reference keeps);
    ``min_d``: each slot's best f32 distance.  The rule: the slots kept and
    under ``dist_th`` are good, and the ``n_corrs`` good ones of the highest
    Gumbel key -log(-log(u)) of their output draw u (ties to the lower slot)
    are served.  A slot within ``SELECTION_BAND`` of ``dist_th`` is good or
    not as the program's rounding decides; the others are held exactly."""
    import torch
    th = pipe["dist_th"]
    sure = src_valid & (min_d < th - SELECTION_BAND)
    maybe = src_valid & (min_d < th + SELECTION_BAND)
    order = torch.sort(-torch.log(-torch.log(noise_out)), descending=True, stable=True)[1]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=order.device)
    known = j[j >= 0]
    served = torch.zeros_like(sure)
    served[known] = True
    errors = int((j < 0).sum()) + len(known) - int(served.sum())     # strangers, repeats
    errors += int((served & ~maybe).sum())                            # not good
    left_out = sure & ~served
    if len(j) >= pipe["n_corrs"] and len(known):    # full: a good slot ranked above a served one
        left_out &= rank < rank[known].max()
    return errors + int(left_out.sum())


def solve(pose, ref_pdsc, sample: Dict, noise, pipe: Dict, ma, mq):
    """The reference's pose stages on the served correspondences and masks:
    (PointDSC's pose and confidence, and ICP from the served PointDSC pose,
    the identity where fewer than 4 correspondences are valid)."""
    import torch
    FH, FW = ma.shape[1:]
    depth_a, depth_q, cam_a, cam_q = sample["depth"]
    pa, pq, ok = pose.lift_corrs(sample["corrs"], sample["corr_valid"].bool(), depth_a, depth_q,
                                 cam_a, cam_q, (FH, FW))
    T, conf = ref_pdsc(pa, pq, ok.float())
    ca, va = pose.mask_cloud(noise.icp_a, ma, depth_a, cam_a, (FH, FW), pipe["icp_points"])
    cq, vq = pose.mask_cloud(noise.icp_q, mq, depth_q, cam_q, (FH, FW), pipe["icp_points"])
    T_icp = pose.masked_icp(ca, va, cq, vq, sample["pointdsc_T"], pipe["icp_iters"],
                            pipe["icp_trim"])
    enough = (ok.float().sum(-1) >= 4)[:, None, None]
    return T, conf, torch.where(enough, T_icp, torch.eye(4, device=T.device).expand_as(T_icp))


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the sampled requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}
