"""Layers shared by the port's modules, with the JAX package's precision
policy: parameters are stored in f32 and cast to the compute dtype at use
(as flax modules with ``dtype=bf16`` do); LayerNorm and GroupNorm compute in
f32 and return f32.  Convolutions take and return NHWC tensors, the public
layout of the JAX package; inside they run on channels-last views.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from oryon_tpu_torch.parallel.mesh import (copy_to_group, group_rank, group_size,
                                           reduce_from_group, scatter_to_group,
                                           shard_index)


class Dense(nn.Module):
    """y = x W^T + b in ``dtype`` (torch Linear layout: weight [out, in])."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class ColumnParallelDense(Dense):
    """Tensor-parallel ``Dense`` whose output features are split over
    ``group`` (Megatron's column-parallel layer): this rank holds rows
    ``shard_index(out, n, r, parts)`` of the weight and the bias, and
    computes those output features from the whole (replicated) input.  A
    packed q | k | v projection has ``parts=3``, so that the rank holds the
    q, k and v rows of its own heads, packed [q_r | k_r | v_r]."""

    tp_dim = 0

    def __init__(self, dense: Dense, group, parts: int = 1):
        nn.Module.__init__(self)
        n, r = group_size(group), group_rank(group)
        self.full_features, self.parts = dense.weight.shape[0], parts
        idx = shard_index(self.full_features, n, r, parts)
        self.weight = nn.Parameter(dense.weight.detach()[idx].clone())
        self.bias = (None if dense.bias is None
                     else nn.Parameter(dense.bias.detach()[idx].clone()))
        self.dtype, self.group = dense.dtype, group

    def shard_index(self, r: int) -> torch.Tensor:
        return shard_index(self.full_features, group_size(self.group), r, self.parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_group(x, self.group))


class RowParallelDense(Dense):
    """Tensor-parallel ``Dense`` whose input features are split over
    ``group`` (Megatron's row-parallel layer): this rank holds its 1/n of
    the weight's input columns, the partial products are summed over the
    group and the whole bias is added once.  ``input_is_parallel=False``
    takes a replicated input and slices this rank's part of it first."""

    tp_dim = 1
    parts = 1

    def __init__(self, dense: Dense, group, input_is_parallel: bool = True):
        nn.Module.__init__(self)
        n, r = group_size(group), group_rank(group)
        self.full_features = dense.weight.shape[1]
        self.weight = nn.Parameter(
            dense.weight.detach()[:, shard_index(self.full_features, n, r)].clone())
        self.bias = dense.bias
        self.dtype, self.group = dense.dtype, group
        self.input_is_parallel = input_is_parallel

    def shard_index(self, r: int) -> torch.Tensor:
        return shard_index(self.full_features, group_size(self.group), r)

    def local_input(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.input_is_parallel else scatter_to_group(x, self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.local_input(x).to(self.dtype), self.weight.to(self.dtype))
        y = reduce_from_group(y, self.group)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """2-D convolution on NHWC tensors (weight [out, in, kh, kw])."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """Transposed convolution with stride == kernel on NHWC tensors
    (torch layout: weight [in, out, kh, kw])."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.kernel, self.dtype = kernel, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=self.kernel)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in f32, returning f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC tensors (consecutive channel groups), in f32."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        g = x.float().reshape(B, H * W, self.groups, C // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        return g.reshape(B, H, W, C) * self.weight + self.bias


# std of the normal init of named free parameters (flax initialisers)
_PARAM_STD = {"class_embedding": 0.02, "positional_embedding": 0.02,
              "token_embedding": 0.02, "relative_position_bias_table": 0.02}


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in the manner of the flax initialisers: weights
    N(0, 1/fan_in), biases 0, norm scales 1, embeddings N(0, 0.02^2)."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, (Dense, Conv, ConvTranspose)):
            fan_in = m.weight[0].numel() if not isinstance(m, ConvTranspose) \
                else m.weight.shape[0] * m.weight[0, 0].numel()
            normal_(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (LayerNorm, GroupNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for name, p in m.named_parameters(recurse=False):
            if name in _PARAM_STD:
                normal_(p, _PARAM_STD[name])
            elif name == "text_projection":
                normal_(p, p.shape[0] ** -0.5)
            elif name == "sigma":
                p.fill_(1.0)
    return module


def dense_cls(quant: str):
    """Dense or its int8 drop-in (same parameters), by config string."""
    from oryon_tpu_torch.models.quant import QuantDense
    if quant not in ("none", "int8"):
        raise ValueError(f"quant {quant!r} not in ('none', 'int8')")
    return QuantDense if quant == "int8" else Dense
