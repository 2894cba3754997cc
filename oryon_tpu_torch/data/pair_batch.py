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
    # [B, P, D] precomputed prompt embeddings (the frozen text tower's
    # output); when set, the model skips the text tower
    text_emb: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.corrs.shape[0]


def device_fields(batch: PairBatch) -> PairBatch:
    """The device subset: drops the host-side id arrays."""
    return batch._replace(cls_id=None, instance_id=None, id_a=None, id_q=None)


def _train_view(v: PairView) -> PairView:
    return v._replace(depth=None, orig_depth=None, eval_depth=None,
                      camera=None, pose=None, size=None)


def train_fields(batch: PairBatch) -> PairBatch:
    """What a training step reads: rgb, mask, corrs and their validity, the
    pair validity and the prompts (``prompt_ids`` dropped when ``text_emb``
    is set, since the model then ignores them).  Depth, camera and poses are
    concerns of pose evaluation."""
    b = device_fields(batch)._replace(
        anchor=_train_view(batch.anchor), query=_train_view(batch.query),
        rel_pose=None)
    if b.text_emb is not None:
        b = b._replace(prompt_ids=None)
    return b
