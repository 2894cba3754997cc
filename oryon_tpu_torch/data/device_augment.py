"""Pair-consistent colour and flip augmentation on the device, inside the
train step.

Counterpart of ``oryon_tpu/data/device_augment.py``, op for op: per view,
with probability ``prob`` each, a colour jitter (brightness 1 ± 0.125,
contrast 1 ± 0.5, saturation 1 ± 0.5, hue ± 0.05, applied in a random order,
torchvision's ColorJitter), a brightness jitter (1 ± 0.25), a horizontal and
a vertical flip of the 224² view (pixel-centre mirror) with the ground-truth
correspondences remapped.  uint8 rgb comes in, f32 rgb in [0, 1] goes out;
mask and depth are mirrored when present.

Drawing and applying are apart: ``draw_factors`` draws every factor from a
``torch.Generator``, and ``apply_factors`` applies given factors, which is
how the parity tests feed the factors the JAX package drew.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_GRAY = (0.299, 0.587, 0.114)
_T_YIQ = np.array([[0.299, 0.587, 0.114],
                   [0.596, -0.274, -0.322],
                   [0.211, -0.523, 0.312]], np.float32)
# the colour jitter's strengths and the brightness jitter's, as ranges
JITTER_RANGES = ((0.875, 1.125), (0.5, 1.5), (0.5, 1.5), (-0.05, 0.05))
BRIGHT_RANGE = (0.75, 1.25)


class DeviceAugConfig(NamedTuple):
    """Switches of the augmentation stack (``cfg.augs.rgb``)."""
    jitter: bool = True
    bright: bool = True
    hflip: bool = True
    vflip: bool = True
    prob: float = 0.5


class AugFactors(NamedTuple):
    """Every draw of one call; axis 0 is the view (anchor, query), axis 1
    the pair."""
    gates: torch.Tensor    # [2, B, 4] f32 uniforms: jitter, bright, hflip, vflip
    jitter: torch.Tensor   # [2, B, 4] f32 brightness, contrast, saturation, hue
    order: torch.Tensor    # [2, B, 4] int64: the jitter's op order, a permutation
    bright: torch.Tensor   # [2, B] f32 brightness factor of the bright jitter


def _per_image(f: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    return f.reshape((-1,) + (1,) * (img.dim() - 1))


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img @ torch.tensor(_GRAY, dtype=img.dtype, device=img.device)


def adjust_brightness(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, 3] in [0, 1], f [B]."""
    return torch.clamp(img * _per_image(f, img), 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    mean = _per_image(_gray(img).mean(dim=(1, 2)), img)
    return torch.clamp((img - mean) * _per_image(f, img) + mean, 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    gray = _gray(img)[..., None]
    return torch.clamp((img - gray) * _per_image(f, img) + gray, 0.0, 1.0)


def _hue_matrix(shift: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] RGB-space hue rotation through the YIQ transform."""
    t = 2.0 * np.pi * shift.float()
    cos, sin = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    rot = torch.stack([one, zero, zero, zero, cos, -sin, zero, sin, cos],
                      dim=-1).reshape(-1, 3, 3)
    t_yiq = torch.as_tensor(_T_YIQ, device=shift.device)
    t_inv = torch.as_tensor(np.linalg.inv(_T_YIQ).astype(np.float32), device=shift.device)
    return t_inv @ rot @ t_yiq


def adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.einsum("bhwc,bdc->bhwd", img, _hue_matrix(shift)), 0.0, 1.0)


_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(img: torch.Tensor, factors: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """The four jitter ops on [B, H, W, 3], image b in the order
    ``order[b]`` with ``factors[b]`` (brightness, contrast, saturation,
    hue)."""
    for i in range(len(_OPS)):
        for o, op in enumerate(_OPS):
            sel = _per_image(order[:, i] == o, img)
            img = torch.where(sel, op(img, factors[:, o]), img)
    return img


def draw_factors(generator: torch.Generator, B: int) -> AugFactors:
    """Every factor of one call for B pairs, on the generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    gates = torch.rand((2, B, 4), generator=generator, device=dev)
    jitter = torch.stack([uniform((2, B), lo, hi) for lo, hi in JITTER_RANGES], dim=-1)
    order = torch.argsort(torch.rand((2, B, 4), generator=generator, device=dev), dim=-1)
    return AugFactors(gates, jitter, order, uniform((2, B), *BRIGHT_RANGE))


def _mirror(x, do_h: torch.Tensor, do_v: torch.Tensor):
    """Conditional mirror of [B, H, W, ...] along W, then along H."""
    if x is None:
        return None
    x = torch.where(_per_image(do_h, x), torch.flip(x, dims=(2,)), x)
    return torch.where(_per_image(do_v, x), torch.flip(x, dims=(1,)), x)


def _remap_corrs(corrs: torch.Tensor, hw, do_h_a, do_v_a, do_h_q, do_v_q) -> torch.Tensor:
    """Mirror the (y1, x1, y2, x2) endpoints [B, N, 4] of flipped views."""
    H, W = hw
    y1, x1, y2, x2 = corrs.unbind(-1)
    y1 = torch.where(do_v_a[:, None], H - 1 - y1, y1)
    x1 = torch.where(do_h_a[:, None], W - 1 - x1, x1)
    y2 = torch.where(do_v_q[:, None], H - 1 - y2, y2)
    x2 = torch.where(do_h_q[:, None], W - 1 - x2, x2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def _to_float(rgb: torch.Tensor) -> torch.Tensor:
    if rgb.dtype == torch.uint8:
        return rgb.float() / 255.0
    return rgb.float()


def apply_factors(batch, factors: AugFactors, cfg: DeviceAugConfig):
    """The augmentation stack on a PairBatch with the given factors."""
    dev = batch.anchor.rgb.device
    f = AugFactors(*(t.to(dev) for t in factors))
    views, flips = [], []
    for s, v in enumerate((batch.anchor, batch.query)):
        rgb, gates = _to_float(v.rgb), f.gates[s]
        if cfg.jitter:
            rgb = torch.where(_per_image(gates[:, 0] < cfg.prob, rgb),
                              color_jitter(rgb, f.jitter[s], f.order[s]), rgb)
        if cfg.bright:
            rgb = torch.where(_per_image(gates[:, 1] < cfg.prob, rgb),
                              adjust_brightness(rgb, f.bright[s]), rgb)
        do_h = (gates[:, 2] < cfg.prob) & bool(cfg.hflip)
        do_v = (gates[:, 3] < cfg.prob) & bool(cfg.vflip)
        views.append(v._replace(rgb=_mirror(rgb, do_h, do_v), mask=_mirror(v.mask, do_h, do_v),
                                depth=_mirror(v.depth, do_h, do_v)))
        flips += [do_h, do_v]
    corrs = _remap_corrs(batch.corrs, batch.anchor.rgb.shape[1:3], *flips)
    return batch._replace(anchor=views[0], query=views[1], corrs=corrs)


def device_augment(batch, generator: torch.Generator, cfg: DeviceAugConfig):
    """Draw the factors from ``generator`` and apply them."""
    return apply_factors(batch, draw_factors(generator, batch.corrs.shape[0]), cfg)
