"""Weight conversion of the port.

Two steps, both plain numpy layout maps:

1. ``convert_*``: original torch state dicts (OpenAI CLIP, torchvision
   Swin-B, the CATSeg fusion / decoder, the PointDSC snapshot), as
   ``dict[str, np.ndarray]`` from ``load_torch_state`` or ``load_npz_state``,
   -> the flax-layout variable tree the JAX package trains and saves.  The
   port's own copy of the converters of ``oryon_tpu/models/convert.py``:

     * Linear [out, in]                 -> kernel [in, out]
     * Conv2d [out, in, kh, kw]         -> kernel [kh, kw, in, out]
     * ConvTranspose2d [in, out, kh, kw] -> kernel [kh, kw, in, out], flipped
     * Conv1d k=1 [out, in, 1]          -> Dense kernel [in, out]
     * LayerNorm / GroupNorm            -> scale / bias
     * BatchNorm                        -> scale / bias + batch_stats
     * CLIP blocks stacked on axis 0 under ``resblocks/block`` (``scan``)

2. ``from_jax_params``: a flax variable tree (converted as above, exported
   from a checkpoint of the JAX package, or read by ``load_flax_npz``) -> a
   state dict of the port's module of the same structure.  The port's
   modules carry the flax module names, so this is a layout map over the
   tree:

     * Dense kernel [in, out]               -> weight [out, in]
     * Conv kernel [kh, kw, in, out] (HWIO) -> weight [out, in, kh, kw]
     * ConvTranspose kernel (modules named ``up``; flax's mirrored kernel
       convention) -> weight [in, out, kh, kw], spatially flipped back
     * LayerNorm / GroupNorm / BatchNorm scale -> weight
     * BatchNorm batch_stats mean / var     -> running_mean / running_var
     * the scanned blocks under ``resblocks/block`` -> resblocks.0, ...

Leaves may be numpy or JAX arrays; they are read with ``np.asarray``, so
this module needs neither JAX nor flax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _leaf(path, name: str, a: np.ndarray, collection: str, out: Dict) -> None:
    if collection == "batch_stats":
        prefix = ".".join(path)
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        name = {"mean": "running_mean", "var": "running_var"}[name]
    elif name == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4 and path[-1] == "up":
            a = np.flip(a, axis=(0, 1)).transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {a.ndim} at {path}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    out[".".join([*path, name])] = torch.from_numpy(np.ascontiguousarray(a))


def _walk(tree: Mapping, path, collection: str, out: Dict) -> None:
    for k, v in tree.items():
        if not isinstance(v, Mapping):
            _leaf(path, k, np.asarray(v), collection, out)
        elif k == "resblocks" and set(v) == {"block"}:
            stacked = v["block"]
            n = len(np.asarray(_first_leaf(stacked)))
            for i in range(n):
                _walk(_index(stacked, i), [*path, k, str(i)], collection, out)
        else:
            _walk(v, [*path, k], collection, out)


def _first_leaf(tree: Mapping) -> Any:
    v = next(iter(tree.values()))
    return _first_leaf(v) if isinstance(v, Mapping) else v


def _index(tree: Mapping, i: int) -> Dict:
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def from_jax_params(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables ({"params": ..., optional "batch_stats": ...}) ->
    a state dict for the port's module with the same structure (OryonModel,
    its submodules, or PointDSC)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        if collection in variables:
            _walk(variables[collection], [], collection, out)
    return out


def load_flax_npz(path: str) -> Dict[str, Any]:
    """A flat npz of '/'-joined flax variable paths (``params/...``,
    ``batch_stats/...``: the format of a PointDSC ``native.npz`` and of an
    exported checkpoint's ``params.npz``) -> the nested variable tree."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


def save_flax_npz(path: str, variables: Mapping) -> None:
    """The inverse of ``load_flax_npz``: a nested variable tree -> a flat
    npz of '/'-joined paths."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(variables, "")
    np.savez(path, **flat)


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The inverse of ``from_jax_params`` for a module of Dense, norm and
    BatchNorm layers and bare parameters (PointDSC): a state dict -> the
    flax variable tree {"params": ..., "batch_stats": ...}.  Dense weight
    [out, in] -> kernel [in, out]; norm weights -> scale; running mean /
    var -> batch_stats mean / var; ``num_batches_tracked`` is dropped."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        a = t.detach().cpu().numpy()
        collection = "params"
        if name in ("running_mean", "running_var"):
            collection, name = "batch_stats", name[len("running_"):]
        elif name == "weight" and a.ndim == 2:
            a, name = a.T, "kernel"
        elif name == "weight" and a.ndim == 1:
            name = "scale"
        elif name == "weight":
            raise ValueError(f"to_jax_params: no flax layout for {key} {a.shape}")
        node = out[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return {k: v for k, v in out.items() if v}


# ---- original torch state dicts -> flax-layout trees ------------------------
def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A published torch pickle (``.pth`` / ``.pkl``; a bare state dict or
    one under ``model`` / ``state_dict``) as numpy arrays by key."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in raw.items()
            if hasattr(v, "detach")}


def load_npz_state(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _with_bias(sd: Dict, prefix: str, kernel: np.ndarray) -> Dict[str, np.ndarray]:
    out = {"kernel": kernel}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def linear(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return _with_bias(sd, prefix, sd[f"{prefix}.weight"].T)


def conv2d(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return _with_bias(sd, prefix, sd[f"{prefix}.weight"].transpose(2, 3, 1, 0))


def conv_transpose2d(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    # torch computes a true transposed convolution, flax uses the mirrored
    # kernel: flip the spatial dims
    w = sd[f"{prefix}.weight"]   # [in, out, kh, kw]
    return _with_bias(sd, prefix, np.flip(w.transpose(2, 3, 0, 1), axis=(0, 1)).copy())


def conv1d_as_dense(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return _with_bias(sd, prefix, sd[f"{prefix}.weight"][:, :, 0].T)


def norm(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def batchnorm(sd: Dict, prefix: str):
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return norm(sd, prefix), stats


def mha_packed(sd: Dict, prefix: str) -> Dict[str, Any]:
    """torch ``nn.MultiheadAttention`` (packed in_proj) -> {in_proj, out_proj}."""
    return {"in_proj": {"kernel": sd[f"{prefix}.in_proj_weight"].T,
                        "bias": sd[f"{prefix}.in_proj_bias"]},
            "out_proj": linear(sd, f"{prefix}.out_proj")}


def _resblock_params(sd: Dict, b: str) -> Dict:
    return {"ln_1": norm(sd, f"{b}.ln_1"),
            "ln_2": norm(sd, f"{b}.ln_2"),
            "attn": mha_packed(sd, f"{b}.attn"),
            "mlp_c_fc": linear(sd, f"{b}.mlp.c_fc"),
            "mlp_c_proj": linear(sd, f"{b}.mlp.c_proj")}


def _stack_blocks(blocks):
    """Per-layer trees -> one tree with the leaves stacked on axis 0."""
    first = blocks[0]
    if isinstance(first, Mapping):
        return {k: _stack_blocks([b[k] for b in blocks]) for k in first}
    return np.stack(blocks, 0)


def _with_resblocks(p: Dict, sd: Dict, prefix: str, layers: int, scan: bool) -> Dict:
    blocks = [_resblock_params(sd, f"{prefix}.{i}") for i in range(layers)]
    if scan:
        p["resblocks"] = {"block": _stack_blocks(blocks)}
    else:
        p.update({f"resblock_{i}": b for i, b in enumerate(blocks)})
    return {"params": p}


def convert_clip_visual(sd: Dict, layers: int = 24, scan: bool = True) -> Dict:
    """OpenAI CLIP ``visual.`` keys -> the vision tower's tree."""
    p: Dict[str, Any] = {
        "conv1": {"kernel": sd["visual.conv1.weight"].transpose(2, 3, 1, 0)},
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": norm(sd, "visual.ln_pre"),
        "ln_post": norm(sd, "visual.ln_post"),
    }
    return _with_resblocks(p, sd, "visual.transformer.resblocks", layers, scan)


def convert_clip_text(sd: Dict, layers: int = 12, scan: bool = True) -> Dict:
    p: Dict[str, Any] = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final": norm(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    return _with_resblocks(p, sd, "transformer.resblocks", layers, scan)


def _swin_block(sd: Dict, prefix: str) -> Dict:
    return {
        "norm1": norm(sd, f"{prefix}.norm1"),
        "norm2": norm(sd, f"{prefix}.norm2"),
        "attn": {
            "qkv": linear(sd, f"{prefix}.attn.qkv"),
            "proj": linear(sd, f"{prefix}.attn.proj"),
            "relative_position_bias_table":
                sd[f"{prefix}.attn.relative_position_bias_table"],
        },
        "mlp_fc1": linear(sd, f"{prefix}.mlp.0"),
        "mlp_fc2": linear(sd, f"{prefix}.mlp.3"),
    }


def convert_swin_guidance(sd: Dict) -> Dict:
    """torchvision ``swin_b`` -> the guidance tower's tree (stages 1-2):
    features.0 patch embed (conv 0, norm 2), features.1 stage 1, features.2
    merge 1, features.3 stage 2, features.4 merge 2."""
    p: Dict[str, Any] = {
        "patch_embed": conv2d(sd, "features.0.0"),
        "patch_norm": norm(sd, "features.0.2"),
        "merge1": {"norm": norm(sd, "features.2.norm"),
                   "reduction": {"kernel": sd["features.2.reduction.weight"].T}},
        "merge2": {"norm": norm(sd, "features.4.norm"),
                   "reduction": {"kernel": sd["features.4.reduction.weight"].T}},
    }
    for i in range(2):
        p[f"stage1_block{i}"] = _swin_block(sd, f"features.1.{i}")
        p[f"stage2_block{i}"] = _swin_block(sd, f"features.3.{i}")
    return {"params": p}


def _fusion_swin_block(sd: Dict, prefix: str) -> Dict:
    return {
        "norm1": norm(sd, f"{prefix}.norm1"),
        "norm2": norm(sd, f"{prefix}.norm2"),
        "attn": {name: linear(sd, f"{prefix}.attn.{name}")
                 for name in ("q", "k", "v", "proj")},
        "mlp_fc1": linear(sd, f"{prefix}.mlp.fc1"),
        "mlp_fc2": linear(sd, f"{prefix}.mlp.fc2"),
    }


def convert_fusion(sd: Dict, num_layers: int = 2) -> Dict:
    """``fusion.`` keys (after ``pretrained.catseg_key_surgery``) -> the
    fusion module's tree."""
    p: Dict[str, Any] = {
        "clip_conv": conv1d_as_dense(sd, "fusion.clip_conv"),
        "conv1": conv2d(sd, "fusion.conv1"),
        "guidance_projection": conv2d(sd, "fusion.guidance_projection.0"),
        "text_guidance_projection": linear(sd, "fusion.text_guidance_projection.0"),
    }
    for i in range(num_layers):
        b = f"fusion.layers.{i}"
        p[f"layer_{i}"] = {
            "guidance_norm": norm(sd, f"{b}.swin_block.guidance_norm"),
            "swin_block1": _fusion_swin_block(sd, f"{b}.swin_block.block_1"),
            "swin_block2": _fusion_swin_block(sd, f"{b}.swin_block.block_2"),
            "class_transformer": {
                "norm1": norm(sd, f"{b}.attention.norm1"),
                "norm2": norm(sd, f"{b}.attention.norm2"),
                "q": linear(sd, f"{b}.attention.attention.q"),
                "k": linear(sd, f"{b}.attention.attention.k"),
                "v": linear(sd, f"{b}.attention.attention.v"),
                "mlp_fc1": linear(sd, f"{b}.attention.MLP.0"),
                "mlp_fc2": linear(sd, f"{b}.attention.MLP.2"),
            },
        }
    return {"params": p}


def convert_decoder(sd: Dict) -> Dict:
    """``decoder.`` keys -> the decoder's tree."""

    def up(prefix: str) -> Dict:
        return {
            "up": conv_transpose2d(sd, f"{prefix}.up"),
            "conv": {
                "conv1": conv2d(sd, f"{prefix}.conv.double_conv.0"),
                "gn1": norm(sd, f"{prefix}.conv.double_conv.1"),
                "conv2": conv2d(sd, f"{prefix}.conv.double_conv.3"),
                "gn2": norm(sd, f"{prefix}.conv.double_conv.4"),
            },
        }

    return {"params": {
        "decoder1": up("decoder.decoder1"),
        "decoder2": up("decoder.decoder2"),
        "decoder3": up("decoder.decoder3"),
        "head": conv2d(sd, "decoder.head"),
        "guidance_proj_0": conv2d(sd, "decoder.decoder_guidance_projection.0.0"),
        "guidance_proj_1": conv2d(sd, "decoder.decoder_guidance_projection.1.0"),
    }}


def convert_pointdsc(sd: Dict, num_layers: int = 6) -> Dict:
    """The published PointDSC snapshot -> params + BatchNorm batch_stats."""
    enc_p: Dict[str, Any] = {"layer0": conv1d_as_dense(sd, "encoder.layer0")}
    enc_s: Dict[str, Any] = {}
    for i in range(num_layers):
        pc = f"encoder.blocks.PointCN_layer_{i}"
        bn_p, bn_s = batchnorm(sd, f"{pc}.1")
        enc_p[f"pointcn_{i}"] = {"conv": conv1d_as_dense(sd, f"{pc}.0"), "bn": bn_p}
        enc_s[f"pointcn_{i}"] = {"bn": bn_s}
        nl = f"encoder.blocks.NonLocal_layer_{i}"
        f1p, f1s = batchnorm(sd, f"{nl}.fc_message.1")
        f2p, f2s = batchnorm(sd, f"{nl}.fc_message.4")
        enc_p[f"nonlocal_{i}"] = {
            "projection_q": conv1d_as_dense(sd, f"{nl}.projection_q"),
            "projection_k": conv1d_as_dense(sd, f"{nl}.projection_k"),
            "projection_v": conv1d_as_dense(sd, f"{nl}.projection_v"),
            "fc1": {"conv": conv1d_as_dense(sd, f"{nl}.fc_message.0"), "bn": f1p},
            "fc2": {"conv": conv1d_as_dense(sd, f"{nl}.fc_message.3"), "bn": f2p},
            "fc3": conv1d_as_dense(sd, f"{nl}.fc_message.6"),
        }
        enc_s[f"nonlocal_{i}"] = {"fc1": {"bn": f1s}, "fc2": {"bn": f2s}}
    params = {"sigma": sd["sigma"], "encoder": enc_p,
              "cls1": conv1d_as_dense(sd, "classification.0"),
              "cls2": conv1d_as_dense(sd, "classification.2"),
              "cls3": conv1d_as_dense(sd, "classification.4")}
    return {"params": params, "batch_stats": {"encoder": enc_s}}
