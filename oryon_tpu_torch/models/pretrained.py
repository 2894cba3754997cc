"""Pretrained-weight assembly: load, convert and merge into an ``OryonModel``.

Counterpart of ``oryon_tpu/models/pretrained.py``.  The assets:
  * OpenAI CLIP ViT-L/14@336 (``cfg.pretrained.clip``)
  * torchvision Swin-B (``cfg.pretrained.swin``)
  * the CATSeg checkpoint with its fusion / decoder key surgery
    ('sem_seg_head.predictor.transformer' -> fusion, 'fusion.decoder' ->
    decoder.decoder, 'fusion.head' -> decoder.head) and an optional
    finetuned CLIP that overrides the base one (``cfg.pretrained.catseg``)

Each asset is optional: a missing file leaves the randomly initialised
sub-module as it is and is reported.  A sub-module loads whole or not at all
(``strict=True``): a key or shape that does not fit raises.  The EVA02-CLIP
towers (``model.image_encoder.vlm=eva02``) have no configured checkpoint: no
CLIP weights are loaded into them, and the report says so.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from oryon_tpu_torch.models import convert as C


def catseg_key_surgery(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename the CATSeg checkpoint's keys to ``fusion.`` / ``decoder.`` /
    ``clip.``; every other key is dropped."""
    out = {}
    old_fusion = "sem_seg_head.predictor.transformer"
    old_clip = "sem_seg_head.predictor.clip_model"
    for k, v in sd.items():
        if k.startswith(old_fusion):
            nk = "fusion" + k[len(old_fusion):]
            if nk.startswith("fusion.decoder"):
                nk = "decoder.decoder" + nk[len("fusion.decoder"):]
            elif nk.startswith("fusion.head"):
                nk = "decoder.head" + nk[len("fusion.head"):]
            out[nk] = v
        elif k.startswith(old_clip):
            out["clip" + k[len(old_clip):]] = v
    return out


def _load_any(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        return C.load_npz_state(path)
    return C.load_torch_state(path)


def load_pretrained_params(cfg, model) -> List[str]:
    """Load every available asset into ``model`` (an ``OryonModel`` whose
    widths are the assets': size "full"), in place.  Returns the report, one
    line per asset."""
    report: List[str] = []

    def merge(sub: str, tree: Dict) -> None:
        getattr(model, sub).load_state_dict(C.from_jax_params(tree), strict=True)

    def merge_clip(sd: Dict) -> None:
        merge("vlm_visual", C.convert_clip_visual(sd, layers=model.vision_cfg.layers))
        merge("vlm_text", C.convert_clip_text(sd, layers=model.text_cfg.layers))

    eva = model.vision_cfg.block == "eva02"
    clip_path = cfg.pretrained.clip
    if eva:
        report.append("EVA02-CLIP towers: no EVA02 checkpoint is configured (random init)")
    elif os.path.exists(clip_path):
        merge_clip(_load_any(clip_path))
        report.append(f"loaded CLIP from {clip_path}")
    else:
        report.append("CLIP weights missing (random init)")

    swin_path = cfg.pretrained.swin
    if os.path.exists(swin_path):
        merge("guidance", C.convert_swin_guidance(_load_any(swin_path)))
        report.append(f"loaded Swin-B from {swin_path}")
    else:
        report.append("Swin-B weights missing (random init)")

    catseg_path = cfg.pretrained.catseg
    if cfg.model.use_catseg_ckpt and os.path.exists(catseg_path):
        sd = catseg_key_surgery(_load_any(catseg_path))
        merge("fusion", C.convert_fusion(sd, num_layers=model.fusion_cfg.num_layers))
        merge("decoder", C.convert_decoder(sd))
        report.append(f"loaded CATSeg fusion/decoder from {catseg_path}")
        # a finetuned CLIP inside the CATSeg checkpoint overrides the base one
        clip_sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
        if "visual.conv1.weight" in clip_sd and not eva:
            merge_clip(clip_sd)
            report.append("applied CATSeg-finetuned CLIP override")
    else:
        report.append("CATSeg weights missing (random init)")
    return report
