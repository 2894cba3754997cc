"""Offline metric recomputation from a prediction CSV.

Counterpart of ``scripts/compute_metrics.py``: rebuild the dataset split,
re-register every CSV row through the evaluator (scoring on the device),
write ``<csv>_recomputed.json`` and print the per-class and LaTeX rows.

    python -m oryon_tpu_torch.scripts.compute_metrics <pred.csv> dataset.root=data \
        dataset.test.name=nocs dataset.test.split=cross_scene_test [--device cpu]
"""
from __future__ import annotations

import os
import sys

import numpy as np


def parse_csv(path):
    """(id_a, id_q, relative pose [4, 4] f32, IoU a, IoU q) per line."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 5:
                continue
            id_a, id_q, pose_str, iou_a, iou_q = parts[:5]
            pose = np.eye(4, dtype=np.float32)
            vals = [float(v) for v in pose_str.split(" ")]
            pose[:3, :] = np.asarray(vals, np.float32).reshape(3, 4)
            rows.append((id_a, id_q, pose, float(iou_a), float(iou_q)))
    return rows


def split_index(ds):
    """'<scene> <image> <object>|<scene> <image> <object>' -> instance index."""
    by_key = {}
    for i, (sa, ia, sq, iq, cat_id, obj) in enumerate(ds.instances):
        obj_key = obj if ds.reader.name == "nocs" else int(cat_id)
        by_key[f"{sa} {ia} {obj_key}|{sq} {iq} {obj_key}"] = i
    return by_key


def main(argv):
    """Returns the evaluator with every row registered."""
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.eval.evaluator import Evaluator
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import overrides

    csv_path = argv[0]
    device = _device(argv)
    cfg = load_config(None, overrides(argv[1:]))
    root = os.path.join(cfg.dataset.root, cfg.dataset.test.name)
    ds = PairDataset(pick_reader(cfg.dataset.test.name)(root), cfg.dataset.test.split,
                     ClipTokenizer(), max_corrs=cfg.dataset.max_corrs,
                     img_size=cfg.dataset.img_size)
    by_key = split_index(ds)

    ev = Evaluator(cfg.exp_tag, compute_vsd=cfg.compute_vsd, device=device)
    ev.add_object_info(ds.reader.object_info())
    ev.init_test()

    n_missing = 0
    for id_a, id_q, pred_rel, iou_a, iou_q in parse_csv(csv_path):
        key = f"{id_a}|{id_q}"
        if key not in by_key:
            n_missing += 1
            continue
        sa, ia, sq, iq, cat_id, obj = ds.instances[by_key[key]]
        obj_key = obj if ds.reader.name == "nocs" else int(cat_id)
        item_a = ds.reader.get_item(sa, ia, obj_key)
        item_q = ds.reader.get_item(sq, iq, obj_key)
        if np.count_nonzero(pred_rel[:3, :]) <= 1:
            ev.register_test_failure(iou_a, iou_q, cls_id=obj_key,
                                     instance_id=f"{sa}_{ia}_{sq}_{iq}_{obj}")
            continue
        pred_q = pred_rel @ np.asarray(item_a["pose"], np.float32)
        ev.register_test(
            iou_a, iou_q, gt_pose=np.asarray(item_q["pose"], np.float32),
            pred_pose=pred_q, pred_pose_rel=pred_rel,
            camera=np.asarray(item_q["camera"], np.float32),   # the query view's K
            depth=np.asarray(item_q["depth"], np.float32) if cfg.compute_vsd else None,
            cls_id=obj_key, instance_id=f"{sa}_{ia}_{sq}_{iq}_{obj}")

    out_json = os.path.splitext(csv_path)[0] + "_recomputed.json"
    with open(out_json, "w") as f:
        ev.save(f)
    for row in ev.test_summary():
        print(row)
    print(ev.get_latex_str())
    if n_missing:
        print(f"WARNING: {n_missing} CSV rows not found in the split")
    print(f"wrote {out_json}")
    return ev


if __name__ == "__main__":
    main(sys.argv[1:])
