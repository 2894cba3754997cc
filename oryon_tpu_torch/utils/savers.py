"""Prediction-saving hooks of the evaluation loop: masks as PNG, featmap-
frame correspondences and masks as npz.

Counterpart of ``oryon_tpu/utils/savers.py`` (``test.only_save_masks`` /
``test.only_save_featmaps``).  A hook takes (batch index, PairBatch,
PipelineOutputs) and fetches what it writes from the device.
"""
from __future__ import annotations

import os

import numpy as np


def make_mask_saver(out_dir: str):
    os.makedirs(out_dir, exist_ok=True)

    def hook(batch_idx, batch, out):
        from PIL import Image

        masks_a = out.mask_a.cpu().numpy().astype(np.uint8)
        masks_q = out.mask_q.cpu().numpy().astype(np.uint8)
        for i in range(masks_a.shape[0]):
            if batch.valid is not None and float(batch.valid[i]) == 0:
                continue
            iid = str(batch.instance_id[i]).replace(" ", "_")
            Image.fromarray(masks_a[i] * 255).save(os.path.join(out_dir, f"{iid}_mask_a.png"))
            Image.fromarray(masks_q[i] * 255).save(os.path.join(out_dir, f"{iid}_mask_q.png"))

    return hook


def make_featmap_saver(out_dir: str):
    os.makedirs(out_dir, exist_ok=True)

    def hook(batch_idx, batch, out):
        np.savez_compressed(
            os.path.join(out_dir, f"featmaps_{batch_idx:05d}.npz"),
            corrs=out.corrs.cpu().numpy(), corr_valid=out.corr_valid.cpu().numpy(),
            mask_a=out.mask_a.cpu().numpy(), mask_q=out.mask_q.cpu().numpy(),
            instance_id=np.asarray(batch.instance_id))

    return hook
