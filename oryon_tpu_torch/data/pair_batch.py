"""PairView / PairBatch: the fixed-shape batch contract, as tensors.

Counterpart of ``oryon_tpu/data/pair_batch.py``: every field is a tensor of
fixed shape, variable-size structures carry validity masks.  Depths are in
millimetres, poses in metres.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class PairView(NamedTuple):
    rgb: torch.Tensor          # [B, H, W, 3] uint8 (or float in [0, 1])
    mask: torch.Tensor         # [B, H, W] uint8 (oracle or external mask)
    depth: Optional[torch.Tensor]       # [B, H, W] resized working depth
    orig_depth: torch.Tensor   # [B, Ho, Wo] original-resolution depth
    eval_depth: Optional[torch.Tensor]  # [B, Ho, Wo] scoring depth
    camera: torch.Tensor       # [B, 9] flattened K (original resolution)
    pose: torch.Tensor         # [B, 4, 4] absolute object pose
    size: torch.Tensor         # [B, 2] original (H, W)


class PairBatch(NamedTuple):
    anchor: PairView
    query: PairView
    prompt_ids: Optional[torch.Tensor]  # [B, P, L] tokenized prompt templates
    corrs: torch.Tensor        # [B, N, 4] GT corrs (y1, x1, y2, x2) @ input res
    corr_valid: torch.Tensor   # [B, N] bool
    valid: torch.Tensor        # [B] f32 pair validity
    rel_pose: Optional[torch.Tensor]    # [B, 4, 4] GT relative pose A -> Q
    cls_id: np.ndarray         # [B] host-side class ids
    instance_id: np.ndarray    # [B] host-side instance tags
    id_a: Optional[np.ndarray] = None   # [B] host-side anchor ids "scene img obj"
    id_q: Optional[np.ndarray] = None   # [B] host-side query ids

    @property
    def batch_size(self) -> int:
        return self.corrs.shape[0]
