"""int8 projections (s8 x s8 -> s32) for the frozen CLIP vision tower.

Counterpart of ``oryon_tpu/models/quant.py``.  Symmetric absmax
quantisation: per-output-channel weight scales, computed on the fly from the
f32 weights, and per-token (last-axis) activation scales; the int32 sums are
dequantised by the product of the two scales and the bias is added in f32.

The JAX package runs the integer product in XLA, outside any Pallas kernel,
so on the card it goes to ``torch._int_mm``; a shape that ``_int_mm``
refuses raises.  On the CPU ``_int_mm`` is an exact integer matmul too (a
float32 matmul is not exact here: sums reach 127^2 * 4096 > 2^24).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from oryon_tpu_torch.models.layers import ColumnParallelDense, Dense, RowParallelDense
from oryon_tpu_torch.parallel.mesh import all_reduce_


def int8_quantize(x: torch.Tensor, dim: int,
                  amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantisation along ``dim`` (kept).  Returns (int8
    values, f32 scale) with x ~= values * scale.  ``amax``: the absmax to
    scale by (keepdim shape), when it is taken over more than ``x`` holds."""
    xf = x.float()
    if amax is None:
        amax = torch.amax(torch.abs(xf), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.round(xf / scale)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor],
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ weight^T + bias through an int8 product with int32 sums.

    x [..., in] any float dtype; weight [out, in] f32 (torch Linear layout).
    """
    w8, w_scale = int8_quantize(weight, dim=1)            # [out, in], [out, 1]
    lead = x.shape[:-1]
    x8, a_scale = int8_quantize(x.reshape(-1, x.shape[-1]), dim=-1)  # [M, in], [M, 1]
    # [in, out] view of the row-major [out, in] weights: the column-major
    # second operand that the integer GEMM takes
    acc = torch._int_mm(x8, w8.t())
    out = acc.float() * (a_scale * w_scale.reshape(1, -1))
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype).reshape(*lead, -1)


class QuantDense(Dense):
    """Drop-in ``Dense`` running ``int8_dense``; same parameters, so the
    weight bridge and checkpoints are unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight, self.bias, dtype=self.dtype)



def int8_dense_row_parallel(x: torch.Tensor, weight: torch.Tensor,
                            weight_amax: torch.Tensor, bias: Optional[torch.Tensor],
                            group, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``int8_dense`` of a row-parallel layer: x [..., in/n] and weight
    [out, in/n] hold this rank's 1/n of the input features.  Exact against
    the unsharded product: the per-token activation scale is the absmax of
    the whole row (an all-reduce MAX of the parts' absmax), the weight scale
    is that of the whole weight row (``weight_amax`` [out, 1]), and the
    int32 partial sums are summed over ``group`` before dequantising."""
    w8, w_scale = int8_quantize(weight, dim=1, amax=weight_amax)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    amax = all_reduce_(torch.amax(torch.abs(xf), dim=-1, keepdim=True), group, "max")
    x8, a_scale = int8_quantize(xf, dim=-1, amax=amax)
    acc = all_reduce_(torch._int_mm(x8, w8.t()), group)
    out = acc.float() * (a_scale * w_scale.reshape(1, -1))
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype).reshape(*lead, -1)


class QuantColumnParallelDense(ColumnParallelDense):
    """Column-parallel ``QuantDense``: whole input rows and whole weight rows
    on every rank, so the scales are the unsharded ones and no collective
    is needed."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight, self.bias, dtype=self.dtype)


class QuantRowParallelDense(RowParallelDense):
    """Row-parallel ``QuantDense`` (``int8_dense_row_parallel``).  The
    absmax of each whole weight row is taken over the group when the layer
    first runs and again whenever its weight shard changed (a restore)."""

    _amax = None
    _amax_version = None

    def _weight_amax(self) -> torch.Tensor:
        if self._amax is None or self._amax_version != self.weight._version:
            amax = torch.amax(torch.abs(self.weight.detach().float()), dim=1, keepdim=True)
            self._amax = all_reduce_(amax, self.group, "max")
            self._amax_version = self.weight._version
        return self._amax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense_row_parallel(self.local_input(x), self.weight, self._weight_amax(),
                                       self.bias, self.group, dtype=self.dtype)
