"""Tensor parallelism over the mesh's ``model`` axis for the transformer
towers, the fusion and their checkpoints.

Counterpart of ``oryon_tpu/parallel/tp.py``.  ``tp_spec`` applies the JAX
package's name rules to the port's parameter names (the flax names,
``models/convert.py``) in torch's [out, in] layout:

* column-parallel, weight dim 0 and the bias: ``mlp_c_fc`` / ``mlp_fc1`` and
  ``attn/in_proj`` / ``attn/qkv``;
* row-parallel, weight dim 1, the bias whole: ``mlp_c_proj`` / ``mlp_fc2``
  and ``attn/out_proj`` / ``attn/proj``.

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here ``shard_params_tp`` swaps each matched ``Dense`` / ``QuantDense`` for
its column- or row-parallel form (``models/layers.py``, ``models/quant.py``),
which holds its local shard and calls the collectives itself.  Where GSPMD
reshards the packed q | k | v axis of ``in_proj`` / ``qkv`` after a
contiguous split, the port gives each rank the q, k and v rows of its own
heads, and the attention then runs on heads/n heads of the unchanged head
dim (K1, K3 and K4 see the local heads).  The fusion's window attention has
separate q, k and v, which no rule matches: its ``attn/proj`` is
row-parallel on a replicated input, which it slices.

Checkpoints hold the unsharded state: ``full_state_dict`` and
``full_optimizer_state`` gather the shards (parameters and AdamW moments),
``local_state_dict`` and ``local_optimizer_state`` cut a full state to this
rank's shards.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from oryon_tpu_torch.models.layers import ColumnParallelDense, Dense, RowParallelDense
from oryon_tpu_torch.models.quant import (QuantColumnParallelDense, QuantDense,
                                          QuantRowParallelDense)
from oryon_tpu_torch.parallel.mesh import Mesh, all_gather, group_rank, group_size

COLUMN = ("mlp_c_fc", "mlp_fc1", "attn/in_proj", "attn/qkv")
ROW = ("mlp_c_proj", "mlp_fc2", "attn/out_proj", "attn/proj")
PARALLEL = (ColumnParallelDense, RowParallelDense)


def _path(name: str) -> str:
    return name.replace(".", "/")


def tp_spec(name: str, param: torch.Tensor) -> Optional[int]:
    """The dim of parameter ``name`` (as ``named_parameters`` gives it) that
    is split over ``model``, or None when it is replicated."""
    path = _path(name)
    if any(k in path for k in COLUMN):
        return 0
    if any(k in path for k in ROW) and path.endswith("weight") and param.dim() >= 2:
        return 1
    return None


def _kind(module_name: str) -> Optional[str]:
    path = _path(module_name) + "/"
    if any(f"{k}/" in path for k in COLUMN):
        return "column"
    if any(f"{k}/" in path for k in ROW):
        return "row"
    return None


def tp_plan(model: torch.nn.Module) -> Dict[str, Tuple[str, int, bool]]:
    """{module name: ("column", parts, _) | ("row", 1, input_is_parallel)}
    for every ``Dense`` that the rules match: the layers ``shard_params_tp``
    swaps.  A packed q | k | v projection has 3 parts; a row-parallel
    projection behind a head-local attention or a column-parallel MLP takes
    a split input, the fusion's attention projection (q, k and v
    replicated) a whole one."""
    modules = dict(model.named_modules())
    plan = {}
    for name, m in modules.items():
        kind = _kind(name)
        if kind is None or not isinstance(m, Dense):
            continue
        parent_name, _, child = name.rpartition(".")
        if kind == "column":
            plan[name] = ("column", 3 if child in ("in_proj", "qkv") else 1, True)
        else:
            sibling = {"out_proj": "in_proj", "proj": "qkv",
                       "mlp_c_proj": "mlp_c_fc", "mlp_fc2": "mlp_fc1"}[child]
            sib = f"{parent_name}.{sibling}" if parent_name else sibling
            plan[name] = ("row", 1, sib in modules and _kind(sib) == "column")
    return plan


def shard_params_tp(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Swap every layer of ``tp_plan`` for its tensor-parallel form over
    ``mesh.model_group``, in place, and make the attention of a sharded
    packed projection keep its local heads.  Returns ``model``.  A model
    with ``mesh.shape["model"] == 1`` is returned as it is."""
    group = mesh.model_group
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return model
    modules = dict(model.named_modules())
    for name, (kind, parts, split) in tp_plan(model).items():
        m = modules[name]
        if isinstance(m, PARALLEL):
            continue
        parent_name, _, child = name.rpartition(".")
        parent = modules[parent_name] if parent_name else model
        quant = isinstance(m, QuantDense)
        if kind == "column":
            cls = QuantColumnParallelDense if quant else ColumnParallelDense
            setattr(parent, child, cls(m, group, parts=parts))
            if parts == 3:
                parent.shard_heads(n, r, group)
        else:
            cls = QuantRowParallelDense if quant else RowParallelDense
            setattr(parent, child, cls(m, group, input_is_parallel=split))
    return model


def _parallel_modules(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{state-dict name of a shard: its parallel module}."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, PARALLEL):
            prefix = f"{name}." if name else ""
            out[prefix + "weight"] = m
            if m.bias is not None and m.tp_dim == 0:
                out[prefix + "bias"] = m
    return out


def shard_dims(model: torch.nn.Module) -> Dict[str, int]:
    """{state-dict name: split dim} of the tensor-parallel shards the model
    holds (empty for an unsharded model)."""
    return {k: m.tp_dim for k, m in _parallel_modules(model).items()}


def _gather(t: torch.Tensor, m, dim: int) -> torch.Tensor:
    """The unsharded tensor from every rank's shard ``t`` of module ``m``."""
    n = group_size(m.group)
    parts = all_gather(t.detach(), m.group, dim=dim).split(t.shape[dim], dim=dim)
    shape = list(t.shape)
    shape[dim] = m.full_features
    full = torch.empty(shape, dtype=t.dtype, device=t.device)
    for r in range(n):
        full.index_copy_(dim, m.shard_index(r).to(t.device), parts[r])
    return full


def _local(t: torch.Tensor, m, dim: int) -> torch.Tensor:
    idx = m.shard_index(group_rank(m.group)).to(t.device)
    return t.index_select(dim, idx)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered into the unsharded
    tensor: the state of the unsharded model.  A collective over each
    sharded module's group, so every rank calls it."""
    par = _parallel_modules(model)
    return {k: _gather(v, par[k], par[k].tp_dim) if k in par else v
            for k, v in model.state_dict().items()}


def local_state_dict(model: torch.nn.Module, full: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """An unsharded state cut to this rank's shards of ``model``."""
    par = _parallel_modules(model)
    return {k: _local(v, par[k], par[k].tp_dim) if k in par else v
            for k, v in full.items()}


def _optimizer_params(optimizer, model):
    """[(state index, name, parallel module or None)] in the order of
    ``optimizer.state_dict()``."""
    names = {id(p): n for n, p in model.named_parameters()}
    par = _parallel_modules(model)
    out, i = [], 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            out.append((i, n, par.get(n)))
            i += 1
    return out


def _map_state(osd: dict, optimizer, model, fn) -> dict:
    state = dict(osd["state"])
    for i, _, m in _optimizer_params(optimizer, model):
        if m is None or i not in state:
            continue
        state[i] = {k: fn(v, m, m.tp_dim) if isinstance(v, torch.Tensor) and v.dim() else v
                    for k, v in state[i].items()}
    return {**osd, "state": state}


def full_optimizer_state(optimizer, model: torch.nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of every shard gathered:
    the state of the unsharded model's optimizer (a collective)."""
    return _map_state(optimizer.state_dict(), optimizer, model, _gather)


def local_optimizer_state(optimizer, model: torch.nn.Module, full: dict) -> dict:
    """An unsharded optimizer state cut to this rank's shards."""
    return _map_state(full, optimizer, model, _local)


def copy_module(module: torch.nn.Module) -> torch.nn.Module:
    """``copy.deepcopy`` of a module whose sharded layers keep their process
    groups (a group cannot be copied; the copy shares it)."""
    memo = {}
    for m in module.modules():
        for g in (getattr(m, "group", None), getattr(m, "tp_group", None)):
            if g is not None:
                memo[id(g)] = g
    return copy.deepcopy(module, memo)
