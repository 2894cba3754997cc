"""Classical SIFT baseline through the same mask / solver / evaluator harness.

Counterpart of ``scripts/sift_baseline.py``: SIFT keypoints inside the
oracle masks, ratio-test descriptor matching (OpenCV, on the host), depth
lift, the port's parallel RANSAC (512 hypotheses drawn from a
``torch.Generator`` on the device) and the per-pair evaluator.  Needs
OpenCV (``cv2``); without it ``sift_match`` raises an ImportError that
names it.

    python -m oryon_tpu_torch.scripts.sift_baseline dataset.root=data \
        dataset.test.name=nocs dataset.test.split=cross_scene_test [--device cpu]
"""
from __future__ import annotations

import os
import sys

import numpy as np

HYPOTHESES = 512


def sift_match(rgb_a, mask_a, rgb_q, mask_q, ratio=0.8, max_corrs=500):
    """Masked SIFT keypoints + brute-force ratio-test matching -> [N, 4]
    (y1, x1, y2, x2)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("sift_baseline needs OpenCV (the cv2 module), which this "
                          "installation lacks") from e

    sift = cv2.SIFT_create()
    g_a = cv2.cvtColor((np.clip(rgb_a, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    g_q = cv2.cvtColor((np.clip(rgb_q, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    kp_a, des_a = sift.detectAndCompute(g_a, (mask_a > 0).astype(np.uint8))
    kp_q, des_q = sift.detectAndCompute(g_q, (mask_q > 0).astype(np.uint8))
    if des_a is None or des_q is None or len(kp_a) < 4 or len(kp_q) < 4:
        return np.zeros((0, 4), np.int32)
    matches = cv2.BFMatcher().knnMatch(des_a, des_q, k=2)
    rows = []
    for pair in matches:
        if len(pair) == 2 and pair[0].distance < ratio * pair[1].distance:
            m = pair[0]
            xa, ya = kp_a[m.queryIdx].pt
            xq, yq = kp_q[m.trainIdx].pt
            rows.append([ya, xa, yq, xq])
    if not rows:
        return np.zeros((0, 4), np.int32)
    return np.asarray(rows[:max_corrs]).round().astype(np.int32)


def draw_hypotheses(generator, device):
    """The uniforms of one pair's RANSAC minimal sets, [1, HYPOTHESES, 4]."""
    import torch
    return torch.rand((1, HYPOTHESES, 4), generator=generator, device=device)


def register_pair(item_a, item_q, corrs, uniforms, device):
    """The relative pose [4, 4] of one pair from its matches: both views'
    depth lifted at the matched pixels (metres), RANSAC at 1 cm."""
    import torch

    from oryon_tpu_torch.geometry.kabsch import ransac_kabsch
    from oryon_tpu_torch.geometry.pcd import lift_pcd_at

    def lift(item, yx):
        depth = torch.as_tensor(np.asarray(item["depth"], np.float32), device=device)
        cam = torch.as_tensor(np.asarray(item["camera"], np.float32).reshape(1, 9),
                              device=device)
        return lift_pcd_at(depth[None], cam, torch.as_tensor(yx, device=device)[None]) / 1000.0

    pa, pq = lift(item_a, corrs[:, :2]), lift(item_q, corrs[:, 2:])
    w = ((pa[..., 2] > 0) & (pq[..., 2] > 0)).float()
    T, _ = ransac_kabsch(pa, pq, w, uniforms, match_err=0.01)
    return T[0].cpu().numpy()


def main(argv):
    """Returns the evaluator with every pair registered."""
    import torch

    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.eval.evaluator import Evaluator
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import overrides

    device = _device(argv)
    cfg = load_config(None, overrides(argv))
    root = os.path.join(cfg.dataset.root, cfg.dataset.test.name)
    reader = pick_reader(cfg.dataset.test.name)(root)
    ds = PairDataset(reader, cfg.dataset.test.split, ClipTokenizer(),
                     max_corrs=cfg.dataset.max_corrs, img_size=cfg.dataset.img_size)
    ev = Evaluator("SIFT", compute_vsd=cfg.compute_vsd, vsd_window=cfg.eval.vsd_window,
                   device=device)
    ev.add_object_info(reader.object_info())
    ev.init_test()

    generator = torch.Generator(device=device).manual_seed(0)
    for i in range(len(ds)):
        sa, ia, sq, iq, cat_id, obj = ds.instances[i]
        obj_key = obj if reader.name == "nocs" else int(cat_id)
        item_a = reader.get_item(sa, ia, obj_key)
        item_q = reader.get_item(sq, iq, obj_key)
        iid = f"{sa}_{ia}_{sq}_{iq}_{obj}"
        corrs = sift_match(item_a["rgb"], item_a["mask"], item_q["rgb"], item_q["mask"],
                           max_corrs=cfg.dataset.max_corrs)
        if corrs.shape[0] < 4:
            ev.register_test_failure(1.0, 1.0, cls_id=obj_key, instance_id=iid)
            continue
        pred_rel = register_pair(item_a, item_q, corrs, draw_hypotheses(generator, device),
                                 device)
        pred_q = pred_rel @ np.asarray(item_a["pose"], np.float32)
        ev.register_test(1.0, 1.0, gt_pose=np.asarray(item_q["pose"], np.float32),
                         pred_pose=pred_q, pred_pose_rel=pred_rel,
                         camera=np.asarray(item_q["camera"], np.float32),
                         depth=np.asarray(item_q["depth"], np.float32)
                         if cfg.compute_vsd else None,
                         cls_id=obj_key, instance_id=iid)

    for row in ev.test_summary():
        print(row)
    print(ev.get_latex_str())
    means = ev.get_means()
    print("[sift] " + " ".join(f"{k}={v:.3f}" for k, v in sorted(means.items())
                               if isinstance(v, float)), flush=True)
    return ev


if __name__ == "__main__":
    main(sys.argv[1:])
