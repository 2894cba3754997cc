"""Null pose baselines over a fixed split: the identity relative pose and
the ground truth.

Counterpart of ``scripts/null_baselines.py``: two solver-free predictors
scored through the same ``BatchedEvaluator`` (and VSD) path as
``run_test_torch.py``, on the device.  ``identity`` predicts pose_q =
pose_a and must land far below a trained model; ``gt`` predicts the
annotated relative pose and must score 1 on every recall.

    python -m oryon_tpu_torch.scripts.null_baselines dataset.root=data_synth \
        dataset.test.name=shapenet6d dataset.test.split=val [--device cpu]
"""
from __future__ import annotations

import os
import sys

import numpy as np

IOU_KEYS = ("Anchor IoU", "Query IoU", "Mean IoU", "IoU > .25", "IoU > .5", "IoU > .75")


def run_baseline(cfg, ds, mode: str, device="cpu"):
    """{metric: mean} of one predictor over the split."""
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator

    ev = BatchedEvaluator(f"null-{mode}", compute_vsd=cfg.compute_vsd,
                          vsd_window=cfg.eval.vsd_window, device=device)
    ev.add_object_info(ds.reader.object_info())
    ev.init_test()
    for batch in ds.batches(cfg.dataset.batch_size):
        valid = np.asarray(batch.valid)     # on the host for an eval batch
        live = [i for i in range(valid.shape[0]) if valid[i] != 0]
        if not live:
            continue
        sel = np.asarray(live)
        pose_a = batch.anchor.pose.cpu().numpy()
        gt_q = batch.query.pose.cpu().numpy()
        rel_gt = batch.rel_pose.cpu().numpy()
        if mode == "identity":
            pred_rel = np.broadcast_to(np.eye(4, dtype=np.float32), rel_gt.shape).copy()
        elif mode == "gt":
            pred_rel = rel_gt
        else:
            raise ValueError(mode)
        pred_q = pred_rel @ pose_a
        cameras = batch.query.camera.cpu().numpy().reshape(-1, 3, 3)
        ones = np.ones(len(sel))   # oracle masks: this baseline probes the pose metrics
        ev.register_test_batch(
            ones, ones, gt_q[sel], pred_q[sel], pred_rel[sel],
            [batch.cls_id[i] for i in live], cameras[sel],
            batch.query.eval_depth if cfg.compute_vsd else None,
            [batch.instance_id[i] for i in live], depth_index=sel)
    means = ev.get_means()
    return {k: v for k, v in sorted(means.items()) if isinstance(v, float)}


def main(argv):
    """Returns {mode: {metric: mean}}."""
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import overrides

    device = _device(argv)
    cfg = load_config(None, overrides(argv))
    root = os.path.join(cfg.dataset.root, cfg.dataset.test.name)
    reader = pick_reader(cfg.dataset.test.name)(root)
    ds = PairDataset(reader, cfg.dataset.test.split, ClipTokenizer(),
                     max_corrs=cfg.dataset.max_corrs, img_size=cfg.dataset.img_size,
                     augment=False, mask_type="oracle", device=device)
    print(f"NULL BASELINES on {cfg.dataset.test.name}/{cfg.dataset.test.split}: "
          f"{len(ds)} pairs")
    results = {}
    for mode in ("identity", "gt"):
        results[mode] = means = run_baseline(cfg, ds, mode, device)
        print(f"[{mode}] " + " ".join(f"{k}={v:.3f}" for k, v in means.items()
                                      if k not in IOU_KEYS))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
