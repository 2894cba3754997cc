"""Oryon composition root: frozen VLM + guidance towers, fusion, decoder.

Counterpart of ``oryon_tpu/models/oryon.py``.  Anchor and query run through
the towers as one doubled batch.  Inputs and outputs keep the JAX package's
NHWC layout; the compute dtype is bf16 for the full model, with LayerNorm
and GroupNorm in f32 and the ``clip_conv`` and mask heads in f32, as there.
The model is frozen at serving time: call it under ``torch.inference_mode``.

Training: the towers are frozen unless ``train_towers`` is set; frozen,
they run under ``torch.no_grad()``, the counterpart of the JAX package's
``stop_gradient``, and keep no activations.  With ``train_towers`` the
vision and Swin towers take gradients and recompute each block in backward
(the JAX package's ``remat=train_towers``).  The prompt embeddings never
take a gradient: the text tower is always frozen (the prompt caches).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from oryon_tpu_torch.models.clip import (ClipTextConfig, ClipTextTower,
                                         ClipVisionConfig, ClipVisionTower)
from oryon_tpu_torch.models.decoder import DecoderConfig, StandardDecoder
from oryon_tpu_torch.models.fusion import FusionConfig, ImageTextFusion
from oryon_tpu_torch.models.swin import SwinConfig, SwinGuidance
from oryon_tpu_torch.ops.resize import resize2d

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class OryonOutputs(NamedTuple):
    featmap_a: torch.Tensor   # [B, 192, 192, C]
    featmap_q: torch.Tensor
    mask_a: torch.Tensor      # [B, 192, 192] logits
    mask_q: torch.Tensor


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - m) / s


class OryonModel(nn.Module):
    def __init__(self, fusion_cfg: FusionConfig = FusionConfig(),
                 decoder_cfg: Optional[DecoderConfig] = None,
                 vision_cfg: ClipVisionConfig = ClipVisionConfig(),
                 text_cfg: ClipTextConfig = ClipTextConfig(),
                 swin_cfg: SwinConfig = SwinConfig(),
                 swin_image_size: int = 384, dtype=torch.bfloat16,
                 train_towers: bool = False):
        super().__init__()
        if decoder_cfg is None:
            decoder_cfg = DecoderConfig(guidance_input_dims=(
                2 * swin_cfg.embed_dim, swin_cfg.embed_dim))
        self.fusion_cfg, self.decoder_cfg = fusion_cfg, decoder_cfg
        self.vision_cfg, self.text_cfg, self.swin_cfg = vision_cfg, text_cfg, swin_cfg
        self.swin_image_size, self.dtype = swin_image_size, dtype
        self.train_towers = train_towers
        self.vlm_visual = ClipVisionTower(vision_cfg, dtype, remat=train_towers)
        self.vlm_text = ClipTextTower(text_cfg, dtype)
        self.guidance = SwinGuidance(swin_cfg, dtype, remat=train_towers)
        self.fusion = ImageTextFusion(fusion_cfg, dtype)
        self.decoder = StandardDecoder(decoder_cfg, dtype)

    def encode_towers(self, rgb2: torch.Tensor):
        """The towers over a doubled batch [2B, H, W, 3] in [0, 1]; without
        ``train_towers`` no gradient reaches them or flows out of them."""
        with torch.set_grad_enabled(self.train_towers and torch.is_grad_enabled()):
            return self._towers(rgb2)

    def _towers(self, rgb2: torch.Tensor):
        s = self.vision_cfg.image_size
        clip_in = _normalize(resize2d(rgb2, (s, s), "cubic", align_corners=False),
                             CLIP_MEAN, CLIP_STD)
        visual = self.vlm_visual(clip_in)
        sw = self.swin_image_size
        swin_in = _normalize(resize2d(rgb2, (sw, sw), "cubic", align_corners=True),
                             IMAGENET_MEAN, IMAGENET_STD)
        return visual, self.guidance(swin_in)

    def encode_prompts(self, prompt_ids: torch.Tensor) -> torch.Tensor:
        """[B, P, L] token ids -> [B, P, embed_dim], without gradient."""
        B, P, L = prompt_ids.shape
        with torch.no_grad():
            return self.vlm_text(prompt_ids.reshape(B * P, L)).reshape(B, P, -1)

    def forward(self, rgb_a: torch.Tensor, rgb_q: torch.Tensor,
                prompt_ids: Optional[torch.Tensor] = None,
                text_emb: Optional[torch.Tensor] = None) -> OryonOutputs:
        """Either ``prompt_ids`` [B, P, L] (the text tower runs) or the
        precomputed ``text_emb`` [B, P, D] (the per-prompt cache)."""
        B = rgb_a.shape[0]
        rgb2 = torch.cat([rgb_a, rgb_q], dim=0)
        if not torch.is_floating_point(rgb2):
            rgb2 = rgb2.float() / 255.0   # uint8 wire format
        visual, guid = self.encode_towers(rgb2)
        text = self.encode_prompts(prompt_ids) if text_emb is None else text_emb
        fused = self.fusion(visual, torch.cat([text, text], dim=0), guid[0])
        mask_logits, featmap = self.decoder(fused, guid)
        return OryonOutputs(featmap[:B], featmap[B:], mask_logits[:B],
                            mask_logits[B:])


def full_oryon(dtype=torch.bfloat16, quant: str = "none",
               attn_impl: str = "fused", train_towers: bool = False) -> OryonModel:
    """Production configuration: ViT-L/14@336, Swin-B@384, 192² x 32-ch.

    ``quant="int8"`` runs the CLIP vision projections in int8; the Swin
    tower stays bf16, as in the JAX package (``SwinConfig.quant`` is there
    for a caller that builds its own ``OryonModel``).  ``attn_impl`` selects
    the vision tower's attention kernel (``cfg.model.attn_impl``)."""
    return OryonModel(vision_cfg=ClipVisionConfig(quant=quant, attn_impl=attn_impl),
                      dtype=dtype, train_towers=train_towers)


def small_oryon(dtype=torch.float32, train_towers: bool = False) -> OryonModel:
    """Smoke-test configuration: real tokenizer vocab/context, small towers."""
    return OryonModel(
        vision_cfg=ClipVisionConfig(image_size=112, patch_size=14, width=64,
                                    layers=2, heads=4),
        text_cfg=ClipTextConfig(vocab_size=49408, context_length=77, width=64,
                                layers=2, heads=4, embed_dim=64),
        swin_cfg=SwinConfig(embed_dim=128, depths=(2, 2), heads=(4, 8), window=7),
        swin_image_size=128,
        fusion_cfg=FusionConfig(hidden_dim=128, text_guidance_dim=64,
                                text_guidance_proj_dim=128,
                                appearance_guidance_dim=512,
                                appearance_proj_dim=128, num_layers=2,
                                nheads=4, window=4, pooling=2,
                                num_prompts=8, clip_dim=64, clip_proj_dim=64),
        dtype=dtype, train_towers=train_towers)


def tiny_oryon(dtype=torch.float32, train_towers: bool = False) -> OryonModel:
    """Test configuration: same topology, about 1000x fewer FLOPs."""
    return OryonModel(
        vision_cfg=ClipVisionConfig(image_size=56, patch_size=14, width=64,
                                    layers=2, heads=4),
        text_cfg=ClipTextConfig(vocab_size=600, context_length=16, width=32,
                                layers=2, heads=4, embed_dim=48),
        swin_cfg=SwinConfig(embed_dim=128, depths=(2, 2), heads=(4, 8), window=7),
        swin_image_size=64,
        fusion_cfg=FusionConfig(hidden_dim=128, text_guidance_dim=48,
                                text_guidance_proj_dim=128,
                                appearance_guidance_dim=512,
                                appearance_proj_dim=128, num_layers=2,
                                nheads=4, window=2, pooling=2,
                                num_prompts=8, clip_dim=64, clip_proj_dim=48),
        dtype=dtype, train_towers=train_towers)


MODEL_FACTORIES = {"full": full_oryon, "small": small_oryon, "tiny": tiny_oryon}


def resolve_quant(size: str, quant: str) -> str:
    """Config-level quant resolution for entry points: ``model.quant``
    defaults to "int8", but the int8 path only exists on the full CLIP
    tower, so the small/tiny sizes resolve to "none".  Explicit misuse
    (``build_model(size="tiny", quant="int8")``) still raises."""
    return quant if size == "full" else "none"


def resolve_attn_impl(size: str, attn_impl: str) -> str:
    """Config-level attn_impl resolution, the same policy as
    ``resolve_quant``: the kernel variants are wired for the full CLIP
    vision tower only, so other sizes keep their model default."""
    return attn_impl if size == "full" else "fused"


def build_model(size: str = "full", dtype=None, quant: str = "none",
                attn_impl: str = "fused", train_towers: bool = False) -> OryonModel:
    """Model by size name; quant and attn_impl apply to the full model only."""
    factory = MODEL_FACTORIES[size]
    kwargs = {}
    if dtype is not None:
        kwargs["dtype"] = dtype
    if quant != "none":
        if size != "full":
            raise ValueError("model.quant is only wired for size='full'")
        kwargs["quant"] = quant
    if attn_impl != "fused":
        if size != "full":
            raise ValueError("model.attn_impl is only wired for size='full'")
        kwargs["attn_impl"] = attn_impl
    if train_towers:
        kwargs["train_towers"] = True
    return factory(**kwargs)
