"""Seeded random weights, made on the device in one call a module.

A frozen copy of the served package's initialisation rule (the flax
initialisers): dense and convolution weights N(0, 1/fan_in), biases 0, norm
scales 1 and shifts 0, BatchNorm statistics 0 / 1, the named embeddings
N(0, 0.02^2), ``text_projection`` N(0, 1/width), ``sigma`` 1.  The state
dict is made from the reference module's structure, whose parameter names
are the served model's, and handed to both sides.
"""
from __future__ import annotations

from typing import Dict

import torch

EMBED_STD = {"class_embedding": 0.02, "positional_embedding": 0.02,
             "token_embedding": 0.02, "relative_position_bias_table": 0.02}
WEIGHTED = ("Dense", "_Dense", "Conv", "ConvTranspose")
NORMS = ("LayerNorm", "GroupNorm", "BatchNorm1d")


def _fan_in(mod: torch.nn.Module) -> int:
    w = mod.weight
    if type(mod).__name__ == "ConvTranspose":
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def init_plan(module: torch.nn.Module):
    """(normals [(name, shape, std)], constants {name: (shape, value, dtype)})."""
    normals, consts = [], {}
    for prefix, mod in module.named_modules():
        pre = f"{prefix}." if prefix else ""
        kind = type(mod).__name__
        for name, p in mod.named_parameters(recurse=False):
            full, shape = pre + name, tuple(p.shape)
            if kind in WEIGHTED and name == "weight":
                normals.append((full, shape, _fan_in(mod) ** -0.5))
            elif kind in NORMS:
                consts[full] = (shape, 1.0 if name == "weight" else 0.0, torch.float32)
            elif name in EMBED_STD:
                normals.append((full, shape, EMBED_STD[name]))
            elif name == "text_projection":
                normals.append((full, shape, shape[0] ** -0.5))
            else:   # biases 0, sigma 1
                consts[full] = (shape, 1.0 if name == "sigma" else 0.0, torch.float32)
        if kind == "BatchNorm1d":
            n = mod.num_features
            consts[pre + "running_mean"] = ((n,), 0.0, torch.float32)
            consts[pre + "running_var"] = ((n,), 1.0, torch.float32)
            consts[pre + "num_batches_tracked"] = ((), 0, torch.int64)
    return normals, consts


def make_state(module: torch.nn.Module, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The state dict of ``module``'s structure: every normal draw in one
    ``randn`` on ``device`` from ``generator``, then scaled in place."""
    normals, consts = init_plan(module)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in normals)
    flat = torch.randn(total, generator=generator, device=device)
    state, at = {}, 0
    for name, shape, std in normals:
        n = int(torch.Size(shape).numel())
        state[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, (shape, value, dtype) in consts.items():
        state[name] = torch.full(shape, value, dtype=dtype, device=device)
    return state
