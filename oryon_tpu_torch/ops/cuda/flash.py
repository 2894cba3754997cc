"""Flash multi-head attention on [B, H, L, D] rows with segment ids (K5).

Counterpart of ``oryon_tpu/ops/flash.py``, which wraps the stock Pallas TPU
flash-attention kernel: ``flash_mha`` (unmasked, any L) and
``flash_mha_padded`` (L padded once by the caller, padding isolated by
segment ids).  Query i of image b sees key j only where
``seg[b, i] == seg[b, j]``; padding rows attend among themselves, stay finite
and are dropped by the caller.  The CUDA source is
``oryon_tpu_torch/csrc/flash.cu``; the kernel masks a ragged last tile itself,
so ``flash_mha`` pads nothing.  Which kernel serves which shape
(``kernel_entry``): D = 64 (the ViT-L tower) the wgmma kernel of
``csrc/attn_wgmma.cuh`` (S, P and O in registers, K and V tiles through a TMA
ring), entry ``oryon_flash_mha_wgmma_bf16``; D = 16, 32 and 128 the WMMA
streaming kernel of ``csrc/attn_stream.cuh``, entry ``oryon_flash_mha_bf16``.

Both functions launch the kernel for CUDA tensors and run the plain PyTorch
version (``flash_mha_plain``) for CPU tensors.  Neither takes a gradient, on
either device (``_lib.forward_only``: the backward raises): the JAX package
cannot differentiate its flash kernel (it passes no backward block sizes,
and the stock kernel raises without them), so a tower trained through
``attn_impl=flash`` raises here too.
"""
from __future__ import annotations

from typing import Optional

import torch

from oryon_tpu_torch.ops.cuda import _lib

launches = 0   # kernel launches so far; callers may reset it to 0


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, seg: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain version: f32 logits, pairs of different segments masked out,
    softmax in f32, probabilities cast to the input dtype for the P V
    product."""
    s = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * sm_scale
    if seg is not None:
        same = seg[:, :, None] == seg[:, None, :]          # [B, L, L]
        s = s.masked_fill(~same[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bhmd->bhld", p, v)


def kernel_entry(head_dim: int) -> str:
    """The C entry point that serves this head dimension (see the module
    docstring)."""
    if head_dim not in (16, 32, 64, 128):
        raise ValueError(f"head dim {head_dim} not in (16, 32, 64, 128)")
    return "oryon_flash_mha_wgmma_bf16" if head_dim == 64 else "oryon_flash_mha_bf16"


def _launch(lib, q, k, v, sm_scale: float, seg: Optional[torch.Tensor],
            stream: int) -> torch.Tensor:
    """Allocate the output, call the entry point for this shape on ``lib``
    and count the launch."""
    global launches
    B, H, L, D = q.shape
    fn = getattr(lib, kernel_entry(D))
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if seg is None else seg.data_ptr(), out.data_ptr(), B, H, L, D,
             float(sm_scale), stream)
    _lib.check(err, "flash_mha")
    launches += 1
    return out


def _flash(q, k, v, sm_scale: float, seg: Optional[torch.Tensor]) -> torch.Tensor:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not three [B, H, L, D]")
    B, H, L, D = q.shape
    if seg is not None and seg.shape != (B, L):
        raise ValueError(f"seg {tuple(seg.shape)} != ({B}, {L})")
    return _lib.forward_only("flash_mha (K5, model.attn_impl=flash)",
                             lambda q, k, v: _run(q, k, v, sm_scale, seg), q, k, v)


def _run(q, k, v, sm_scale: float, seg: Optional[torch.Tensor]) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, sm_scale, seg)
    tensors = [q, k, v] + ([] if seg is None else [seg])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and seg must lie on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or (
            seg is not None and seg.dtype != torch.int32):
        raise TypeError("kernel takes bf16 q, k, v and int32 seg")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and seg must be contiguous")
    kernel_entry(q.shape[-1])   # raises on a head dim without a kernel
    return _launch(_lib.library(), q, k, v, sm_scale, seg,
                   torch.cuda.current_stream(q.device).cuda_stream)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v over the last two axes of [B, H, L, D];
    L may be any length.  On a CUDA device the tensors must be bf16 and
    contiguous with D in {16, 32, 64, 128}."""
    return _flash(q, k, v, sm_scale, None)


def flash_mha_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float, seg: torch.Tensor) -> torch.Tensor:
    """``flash_mha`` on inputs the caller padded once: ``seg`` [B, L] int32
    gives padding tokens a segment of their own (0), so real tokens never
    attend to them; padded output rows are to be dropped by the caller."""
    return _flash(q, k, v, sm_scale, seg)
