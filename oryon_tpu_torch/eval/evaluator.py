"""Evaluator: metric registry, failure accounting, summaries, CSV output.

Counterpart of ``oryon_tpu/eval/evaluator.py``: the same metric suite and
bookkeeping (phase-specific metric sets, zero-metric failures, per-class
and aggregate LaTeX rows, the JSON dump) on the port's metric functions
(``eval/metrics.py``, ``eval/bop.py``, ``eval/renderer.py``), run on the
evaluator's device.  The prediction CSV has the reference byte layout
(``id_a,id_q,<12 floats>,iou_a,iou_q``).

``Evaluator`` scores one pair a call; ``BatchedEvaluator`` scores each
object class of a batch in one set of batched calls.  The JAX package pads
class groups to power-of-two buckets and defers its device fetches, both
for its compiler and its host link; here each group is scored as it is and
fetched once, and the rows are appended when a summary is asked for, in the
JAX package's order.  The VSD window guard is kept: a ground-truth
projection wider than the window raises, a predicted one only zeroes that
pair's VSD recall.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from oryon_tpu_torch.eval.bop import (mspd, mspd_recall, mssd, mssd_recall, vsd_errors,
                                      vsd_recall)
from oryon_tpu_torch.eval.metrics import (compute_add, compute_adds,
                                          rotation_translation_errors)
from oryon_tpu_torch.eval.renderer import Mesh, mesh_to, projected_bbox, render_depth_window
from oryon_tpu_torch.geometry.pcd import diameter


def _json_py(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class ObjectInfo:
    """Per-class model data: points (mm), diameter (mm), symmetry set
    [S, 3, 4] and the render mesh for VSD."""

    def __init__(self, pts_mm: np.ndarray, diameter_mm: float,
                 syms: np.ndarray, mesh: Optional[Mesh] = None):
        self.pts = np.asarray(pts_mm, np.float32)       # [N, 3] mm
        self.diameter = float(diameter_mm)
        self.syms = np.asarray(syms, np.float32)        # [S, 3, 4]
        self.mesh = mesh


class Evaluator:
    POSE_RECALL_TH = [(5, 10), (10, 20), (15, 30)]
    # faces a render step takes: bounds the [poses, chunk, Hw, Ww]
    # intermediates (about 270 MB each at 16 poses and 256 px); the render
    # does not depend on it
    RENDER_CHUNK = 64

    def __init__(self, exp_tag: str, compute_vsd: bool = True, compute_iou: bool = True,
                 vsd_delta: float = 15.0, render_hw=(480, 640), vsd_window: int = 128,
                 device="cpu"):
        self.exp_tag = exp_tag
        self.compute_vsd = compute_vsd
        self.compute_iou = compute_iou
        self.vsd_delta = vsd_delta
        self.vsd_taus = list(np.arange(0.05, 0.51, 0.05))
        self.render_hw = render_hw
        # VSD renders a window around the objects' projected bbox (exact,
        # see bop.vsd_errors); it must cover the largest GT-pose projection
        self.vsd_window = vsd_window
        self.device = torch.device(device)
        self.objects: Dict = {}
        self.metrics: Dict[str, List] = {}
        self.counts: Dict[str, List] = {}
        self._cls_tensors: Dict = {}

    # -- object registry ---------------------------------------------------
    def add_object_info(self, objects: Dict[object, ObjectInfo]) -> None:
        self.objects.update(objects)

    def get_obj_info(self, obj_id) -> ObjectInfo:
        return self.objects[obj_id]

    def _tensors(self, cls_id) -> Dict:
        """One class's points, symmetries, mesh and diameters on the
        evaluator's device (cached)."""
        t = self._cls_tensors.get(cls_id)
        if t is None:
            obj = self.get_obj_info(cls_id)
            pts = torch.as_tensor(obj.pts, device=self.device)
            t = dict(pts=pts, syms=torch.as_tensor(obj.syms, device=self.device),
                     mesh=None if obj.mesh is None else mesh_to(obj.mesh, self.device),
                     diam=obj.diameter, add_diam=float(diameter(pts.cpu())) / 1000.0,
                     symmetric=obj.syms.shape[0] > 1)
            self._cls_tensors[cls_id] = t
        return t

    # -- phase init ----------------------------------------------------------
    def clear(self):
        self.metrics = {}
        self.counts = {}

    def init_training(self):
        self.clear()
        if self.compute_iou:
            for k in ("Anchor IoU", "Query IoU", "Mean IoU",
                      "IoU > .25", "IoU > .5", "IoU > .75"):
                self.metrics[k] = []

    def init_validation(self):
        self.init_training()
        for k in ("R error", "T error", "ADD(S)-0.1d", "MSSD", "MSPD"):
            self.metrics[k] = []
        if self.compute_vsd:
            self.metrics["VSD"] = []
            self.metrics["AR"] = []
        for k in ("Missing segm", "Failed pose", "Zero pose"):
            self.counts[k] = []
        for r, t in self.POSE_RECALL_TH:
            self.metrics[f"Recall ({r}deg, {t}cm)"] = []
        for k in ("FMR", "Inlier rate", "Feat ratio"):
            self.metrics[k] = []

    def init_test(self):
        self.init_validation()
        self.metrics["instance_id"] = []
        self.metrics["cls_id"] = []

    # -- scoring ---------------------------------------------------------------
    def _window(self):
        hw = self.render_hw
        return (min(self.vsd_window, hw[0]), min(self.vsd_window, hw[1]))

    def _score(self, cls_id, pred: np.ndarray, gt: np.ndarray, K: np.ndarray,
               depth: Optional[torch.Tensor]) -> np.ndarray:
        """Score n poses of one class: pred, gt [n, 4, 4] (m), K [n, 3, 3],
        depth [n, H, W] scene depth (mm) on the device or None.  Returns
        [n, 8] f64 rows: R error, T error, ADD(S) ok, MSSD recall, MSPD
        recall, VSD recall, GT footprint / window, combined footprint /
        window (the last three 0 without VSD)."""
        c = self._tensors(cls_id)
        dev = self.device
        pred_t = torch.as_tensor(pred, dtype=torch.float32, device=dev)
        gt_t = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        K_t = torch.as_tensor(K, dtype=torch.float32, device=dev)
        errR, errT = rotation_translation_errors(pred_t, gt_t)
        pts_m = c["pts"] / 1000.0
        add = (compute_adds if c["symmetric"] else compute_add)(pts_m, pred_t, gt_t)
        add_ok = (add <= c["add_diam"] * 0.1).float()
        pr, pt = pred_t[:, :3, :3], pred_t[:, :3, 3] * 1000
        gr, gt_ = gt_t[:, :3, :3], gt_t[:, :3, 3] * 1000
        mssd_r = mssd_recall(mssd(pr, pt, gr, gt_, c["pts"], c["syms"]), c["diam"])
        mspd_r = mspd_recall(mspd(pr, pt, gr, gt_, K_t, c["pts"], c["syms"]))
        zeros = torch.zeros_like(mssd_r)
        vsd_r, fp, fpp = zeros, zeros, zeros
        if self.compute_vsd:
            vsd_r, fp, fpp = self._vsd(c, pr, pt, gr, gt_, K_t, depth)
        out = torch.stack([errR, errT, add_ok, mssd_r, mspd_r, vsd_r, fp, fpp], 1)
        return out.double().cpu().numpy()     # one fetch per class group

    def _vsd(self, c, pr, pt, gr, gt_, K, depth):
        """VSD recalls and window footprints of n poses: both renders in a
        window at the clipped corner of the combined projected bbox."""
        mesh, hw, window = c["mesh"], self.render_hw, self._window()
        if tuple(depth.shape[-2:]) != tuple(hw):
            raise ValueError(f"scene depth frame {tuple(depth.shape[-2:])} != the "
                             f"evaluator's render_hw {tuple(hw)}")
        lo_g, hi_g, any_g = projected_bbox(mesh, gr, gt_, K, hw)
        lo_p, hi_p, any_p = projected_bbox(mesh, pr, pt, K, hw)
        big = torch.full_like(lo_g, 1e9)
        lo_c = torch.minimum(torch.where(any_g[:, None], lo_g, big),
                             torch.where(any_p[:, None], lo_p, big))
        hi_c = torch.maximum(torch.where(any_g[:, None], hi_g, -big),
                             torch.where(any_p[:, None], hi_p, -big))
        any_c = (any_g | any_p)[:, None]
        lo_c = torch.where(any_c, lo_c, torch.zeros_like(lo_c))
        hi_c = torch.where(any_c, hi_c, -torch.ones_like(hi_c))
        wvec = torch.tensor(window, dtype=torch.float32, device=self.device)
        fp = ((hi_g - lo_g + 1.0) / wvec).amax(-1)
        fpp = ((hi_c - lo_c + 1.0) / wvec).amax(-1)
        lim = torch.tensor([hw[0] - window[0], hw[1] - window[1]], dtype=torch.float32,
                           device=self.device)
        origin = torch.minimum(torch.clamp(lo_c, min=0.0), lim).to(torch.int64)
        n = pr.shape[0]
        # est and GT renders of every pose in one call
        d_both = render_depth_window(mesh, torch.cat([pr, gr]), torch.cat([pt, gt_]),
                                     torch.cat([K, K]), torch.cat([origin, origin]),
                                     window, self.RENDER_CHUNK)
        d_est, d_gt = d_both[:n], d_both[n:]
        # a clamped dynamic_slice in JAX; the corner is clipped above, so
        # every cut here is whole
        d_win = torch.stack([depth[i, y:y + window[0], x:x + window[1]]
                             for i, (y, x) in enumerate(origin.cpu().tolist())]).float()
        assert tuple(d_win.shape[1:]) == window, (tuple(d_win.shape), window)
        errs = vsd_errors(d_est, d_gt, d_win, K, self.vsd_delta, self.vsd_taus,
                          c["diam"], origin=origin)
        return vsd_recall(errs), fp, fpp

    # -- registration ------------------------------------------------------
    def register_train(self, iou_a: np.ndarray, iou_q: np.ndarray):
        if not self.compute_iou:
            return
        iou_a = np.atleast_1d(np.asarray(iou_a, np.float64))
        iou_q = np.atleast_1d(np.asarray(iou_q, np.float64))
        mean_iou = (iou_a + iou_q) / 2.0
        self.metrics["Anchor IoU"].extend(iou_a.tolist())
        self.metrics["Query IoU"].extend(iou_q.tolist())
        self.metrics["Mean IoU"].extend(mean_iou.tolist())
        self.metrics["IoU > .25"].extend((mean_iou > 0.25).astype(int).tolist())
        self.metrics["IoU > .5"].extend((mean_iou > 0.5).astype(int).tolist())
        self.metrics["IoU > .75"].extend((mean_iou > 0.75).astype(int).tolist())

    def register_eval(self, iou_a, iou_q, gt_pose: np.ndarray, pred_pose: np.ndarray,
                      pred_pose_rel: np.ndarray, cls_id, camera: np.ndarray,
                      depth=None):
        """One pair: poses [4, 4] (m; pred_pose absolute, pred_pose_rel the
        relative one), camera [3, 3], depth [H, W] scene depth (mm) for VSD."""
        self.register_train(iou_a, iou_q)
        pred_pose = np.asarray(pred_pose, np.float32)
        gt_pose = np.asarray(gt_pose, np.float32)
        pred_pose_rel = np.asarray(pred_pose_rel, np.float32)

        self.counts["Missing segm"].append(0)
        zero_pose = int(np.count_nonzero(pred_pose_rel) <= 1)
        failed_pose = int((pred_pose_rel == np.eye(4)).all())
        self.counts["Failed pose"].append(failed_pose)
        self.counts["Zero pose"].append(zero_pose)
        if zero_pose:
            pred_pose = np.eye(4, dtype=np.float32)
        d = None
        if self.compute_vsd:
            assert depth is not None and self.get_obj_info(cls_id).mesh is not None, \
                "VSD needs the scene depth and the object mesh"
            d = torch.as_tensor(np.asarray(depth, np.float32), device=self.device)[None]
        row = self._score(cls_id, pred_pose[None], gt_pose[None],
                          np.asarray(camera, np.float32).reshape(1, 3, 3), d)[0]
        if self.compute_vsd:
            if row[6] > 1.0:
                raise RuntimeError(
                    f"VSD render window too small: GT projection needs "
                    f"{row[6]:.2f}x the window — increase vsd_window "
                    f"(currently {self.vsd_window}, up to the full frame)")
            if row[7] > 1.0:
                row[5] = 0.0   # wild predicted pose: the window cannot hold both
        self._append_row(row)

    def _append_row(self, row: np.ndarray) -> None:
        """The metric rows of one scored pair (``_score``'s columns)."""
        errR, errT = float(row[0]), float(row[1])
        self.metrics["R error"].append(errR)
        self.metrics["T error"].append(errT)
        for r_th, t_th in self.POSE_RECALL_TH:
            self.metrics[f"Recall ({r_th}deg, {t_th}cm)"].append(
                float(errR <= r_th and errT <= t_th))
        self.metrics["ADD(S)-0.1d"].append(float(row[2]))
        self.metrics["MSSD"].append(float(row[3]))
        self.metrics["MSPD"].append(float(row[4]))
        if self.compute_vsd:
            self.metrics["VSD"].append(float(row[5]))
            self.metrics["AR"].append(float((row[3] + row[4] + row[5]) / 3.0))

    def register_test(self, *args, instance_id=None, cls_id=None, **kw):
        self.register_eval(*args, cls_id=cls_id, **kw)
        self.metrics["cls_id"].append(cls_id)
        self.metrics["instance_id"].append(instance_id)

    def register_valid_failure(self, iou_a, iou_q):
        """Automatic zero-metric failure."""
        self.metrics["R error"].append(0.0)
        self.metrics["T error"].append(0.0)
        self.metrics["ADD(S)-0.1d"].append(0.0)
        if self.compute_vsd:
            self.metrics["VSD"].append(0.0)
            self.metrics["AR"].append(0.0)
        self.metrics["MSSD"].append(0.0)
        self.metrics["MSPD"].append(0.0)
        if self.compute_iou:
            # one failure = one row in every metric list
            self.metrics["Anchor IoU"].append(float(np.mean(iou_a)))
            self.metrics["Query IoU"].append(float(np.mean(iou_q)))
            self.metrics["Mean IoU"].append(0.0)
            self.metrics["IoU > .25"].append(0.0)
            self.metrics["IoU > .5"].append(0.0)
            self.metrics["IoU > .75"].append(0.0)
        self.counts["Missing segm"].append(1)
        self.counts["Failed pose"].append(0)
        self.counts["Zero pose"].append(0)
        for r, t in self.POSE_RECALL_TH:
            self.metrics[f"Recall ({r}deg, {t}cm)"].append(0)

    def register_test_failure(self, iou_a, iou_q, cls_id=None, instance_id=None):
        self.register_valid_failure(iou_a, iou_q)
        self.metrics["cls_id"].append(cls_id)
        self.metrics["instance_id"].append(instance_id)

    def register_signal(self, fmr_vals, inlier_vals, feat_ratio_vals=None):
        """Learning-signal metrics per live pair: FMR at the GT
        correspondences, the geometric inlier rate of the predicted matches
        and the continuous feature inlier ratio behind FMR."""
        self.metrics["FMR"].extend(np.atleast_1d(np.asarray(fmr_vals, np.float64)).tolist())
        self.metrics["Inlier rate"].extend(
            np.atleast_1d(np.asarray(inlier_vals, np.float64)).tolist())
        if feat_ratio_vals is not None:
            self.metrics["Feat ratio"].extend(
                np.atleast_1d(np.asarray(feat_ratio_vals, np.float64)).tolist())

    # -- summaries ---------------------------------------------------------
    def get_means(self) -> Dict[str, float]:
        means = {}
        for name, value in self.metrics.items():
            if name not in ("cls_id", "instance_id") and len(value) > 0:
                means[name] = float(np.asarray(value, np.float64).mean())
        return means

    def get_obj_means(self, cls_id) -> Dict[str, float]:
        idxs = np.asarray([c == cls_id for c in self.metrics["cls_id"]])
        means = {}
        for name, value in self.metrics.items():
            if name not in ("cls_id", "instance_id") and len(value) > 0:
                means[name] = float(np.asarray(value, np.float64)[idxs].mean())
        return means

    def _latex_row(self, tag: str, means: Dict[str, float]) -> str:
        if self.compute_vsd:
            row = (f"{tag} & {means['AR']*100:.1f} & {means['VSD']*100:.1f} & "
                   f"{means['MSSD']*100:.1f} & {means['MSPD']*100:.1f} & "
                   f"{means['ADD(S)-0.1d']*100:.1f} &")
        else:
            row = (f"{tag} & - & - & {means['MSSD']*100:.1f} & "
                   f"{means['MSPD']*100:.1f} & {means['ADD(S)-0.1d']*100:.1f} &")
        row += f" {means['Mean IoU']*100:.1f} \\\\" if self.compute_iou else " - \\\\"
        return row

    def get_latex_str(self) -> str:
        return self._latex_row(self.exp_tag, self.get_means())

    def test_summary(self) -> List[str]:
        return [self._latex_row(str(c), self.get_obj_means(c))
                for c in sorted(set(self.metrics["cls_id"]), key=str)]

    def save(self, fp: TextIO) -> None:
        out = dict(self.metrics)
        out.update(self.counts)
        # registered ids may be numpy scalars: coerce so the JSON is writable
        json.dump(out, fp, default=_json_py)


def pred_pose_csv_line(id_a: str, id_q: str, iou_a: float, iou_q: float,
                       pred_pose: np.ndarray) -> str:
    """One line of the prediction CSV: ids, the 12 floats of the [3, 4]
    pose, the two IoUs."""
    pose_str = " ".join(str(n) for n in np.asarray(pred_pose)[:3, :].flatten())
    return ",".join([id_a, id_q, pose_str, str(iou_a), str(iou_q)]) + "\n"


class BatchedEvaluator(Evaluator):
    """Evaluator that scores a batch a call, one set of batched metric calls
    per object class (``register_test_batch``), with the semantics of one
    ``register_test`` call per pair.  The rows join the metric lists when a
    summary is asked for (``flush``), so a sweep's lists hold the same rows
    in the same order as the JAX package's."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._pending: List = []
        self._n_fp_bad = 0

    def register_test_batch(self, iou_a, iou_q, gt_pose, pred_pose, pred_pose_rel,
                            cls_ids, cameras, depths, instance_ids, depth_index=None):
        """Batched registration of the pairs ``cls_ids`` names.

        ``depths``: the scene depths (mm) for VSD, a host array indexed like
        the pairs or, with ``depth_index``, a tensor on the device (any
        dtype) whose rows ``depth_index`` picks; None without VSD."""
        B = len(cls_ids)
        assert depths is not None or not self.compute_vsd, \
            "VSD needs scene depths (same contract as register_eval)"
        pred_pose = np.asarray(pred_pose, np.float32).copy()
        pred_pose_rel = np.asarray(pred_pose_rel, np.float32)
        gt_pose = np.asarray(gt_pose, np.float32)
        zero = np.count_nonzero(pred_pose_rel.reshape(B, -1), axis=1) <= 1
        failed = np.all(pred_pose_rel == np.eye(4, dtype=np.float32), axis=(1, 2))
        pred_pose[zero] = np.eye(4, dtype=np.float32)
        cameras = np.asarray(cameras, np.float32).reshape(B, 3, 3)

        by_cls: Dict = {}
        for i, c in enumerate(cls_ids):
            by_cls.setdefault(c, []).append(i)
        res = np.zeros((B, 8), np.float64)
        for c, idxs in by_cls.items():
            sel = np.asarray(idxs)
            d = None
            if self.compute_vsd:
                if depth_index is not None:
                    rows = torch.as_tensor(np.asarray(depth_index)[sel], device=depths.device)
                    d = depths.index_select(0, rows).to(self.device)
                else:
                    d = torch.as_tensor(np.asarray(depths, np.float32)[sel], device=self.device)
            res[sel] = self._score(c, pred_pose[sel], gt_pose[sel], cameras[sel], d)
        if self.compute_vsd:
            bad = self._check_footprints(res, list(cls_ids), failed, zero)
            res[bad, 5] = 0.0
            self._n_fp_bad += int(bad.sum())
        self._pending.append(dict(res=res, iou_a=np.asarray(iou_a), iou_q=np.asarray(iou_q),
                                  cls_ids=list(cls_ids), instance_ids=list(instance_ids),
                                  failed=failed, zero=zero))

    def _check_footprints(self, res: np.ndarray, cls_ids, failed, zero) -> np.ndarray:
        """Render-window coverage guard.  A GT projection wider than the
        window means ``vsd_window`` is too small for the dataset: raise.  A
        combined bbox that overflows because of a wild predicted pose only
        invalidates that pair's render; returns those rows (zero and failed
        poses, replaced by identity, excluded) for their VSD recall to be
        zeroed."""
        fp_gt = res[:, 6]
        if fp_gt.max() > 1.0:
            i = int(fp_gt.argmax())
            raise RuntimeError(
                f"VSD render window too small: GT projection of class "
                f"{cls_ids[i]!r} needs {fp_gt[i]:.2f}x the "
                f"window — increase vsd_window (currently "
                f"{self.vsd_window}, up to the full frame)")
        real = ~(np.asarray(failed, bool) | np.asarray(zero, bool))
        return real & (res[:, 7] > 1.0)

    def flush(self) -> None:
        """Append the scored batches' rows to the metric lists."""
        for item in self._pending:
            res = item["res"]
            self.register_train(item["iou_a"], item["iou_q"])
            for i in range(res.shape[0]):
                self.counts["Missing segm"].append(0)
                self.counts["Failed pose"].append(int(item["failed"][i]))
                self.counts["Zero pose"].append(int(item["zero"][i]))
                self._append_row(res[i])
                self.metrics["cls_id"].append(item["cls_ids"][i])
                self.metrics["instance_id"].append(item["instance_ids"][i])
        if self._n_fp_bad:
            print(f"WARNING: {self._n_fp_bad} predicted pose(s) project outside "
                  "the VSD render window; their VSD recalls set to 0 "
                  "(pose grossly wrong)")
        self._pending, self._n_fp_bad = [], 0

    def get_means(self):
        self.flush()
        return super().get_means()

    def get_obj_means(self, cls_id):
        self.flush()
        return super().get_obj_means(cls_id)

    def get_latex_str(self) -> str:
        self.flush()
        return super().get_latex_str()

    def test_summary(self):
        self.flush()
        return super().test_summary()

    def save(self, fp) -> None:
        self.flush()
        super().save(fp)

    def clear(self):
        self._pending, self._n_fp_bad = [], 0
        super().clear()
