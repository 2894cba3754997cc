"""The 2D rotary position embedding of the EVA02-CLIP vision tower, in place
on q and k of the packed [B, L, 3C] in_proj output (kernel R1).

The JAX package has no EVA02 tower, so this wrapper ports no TPU kernel.
The CUDA source is ``oryon_tpu_torch/csrc/rope.cu``.  ``rope_qk_`` launches
the kernel for a CUDA tensor (bf16 or f32) and runs the plain version
(``rope_qk_plain_``) for a CPU tensor; K1 then reads the rotated q|k|v as it
reads CLIP's.

What both compute, for every patch row (rows 1..L-1; row 0, the class
token, is not rotated) of every head of q and of k, with f32 tables cos /
sin [L-1, head dim] (``models/clip.rope_tables``): ``t * cos +
rotate_half(t) * sin``, where ``rotate_half(t)[2i] = -t[2i+1]`` and
``rotate_half(t)[2i+1] = t[2i]``, in f32 and rounded once to the storage
type.  v is untouched.  The kernel rounds each product and the sum on its
own, as PyTorch's elementwise operations do, so both give the same bits.

Every kernel launch adds one to ``launches``; every plain call adds one to
the program's counter ``rope_plain`` while spans are on
(``utils/profiling.count``), so a run on the card can show that no rotation
took the plain path.
"""
from __future__ import annotations

import torch

from oryon_tpu_torch.ops.cuda import _lib
from oryon_tpu_torch.utils.profiling import count

launches = 0      # R1 launches so far; callers may reset it to 0
ENTRIES = {torch.bfloat16: "oryon_rope_qk_bf16", torch.float32: "oryon_rope_qk_f32"}


def rotate_plain(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``t * cos + rotate_half(t) * sin`` over the last axis, in f32, returned
    in ``t``'s dtype; cos and sin broadcast against ``t``."""
    tf = t.float()
    half = torch.stack((-tf[..., 1::2], tf[..., 0::2]), dim=-1).flatten(-2)
    return (tf * cos + half * sin).to(t.dtype)


def _shape(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, L, 3C] with C divisible by "
                         f"heads={heads}")
    B, L, C3 = qkv.shape
    hd = C3 // 3 // heads
    if cos.shape != (L - 1, hd) or sin.shape != (L - 1, hd):
        raise ValueError(f"tables {tuple(cos.shape)} / {tuple(sin.shape)} != ({L - 1}, {hd})")
    return B, L, C3 // 3, hd


def rope_qk_plain_(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """Plain version of R1: rotates q and k of the patch rows of ``qkv`` in
    place (differentiable) and returns it."""
    B, L, C, hd = _shape(qkv, cos, sin, heads)
    count("rope_plain")
    qk = qkv[:, 1:, :2 * C].reshape(B, L - 1, 2 * heads, hd)
    rot = rotate_plain(qk, cos.to(qkv.device)[:, None], sin.to(qkv.device)[:, None])
    qkv[:, 1:, :2 * C] = rot.reshape(B, L - 1, 2 * C)
    return qkv


def _launch(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, B: int, L: int, C: int,
            hd: int) -> torch.Tensor:
    global launches
    err = getattr(_lib.library(), ENTRIES[qkv.dtype])(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), B, L, C, hd,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _lib.check(err, "rope_qk_")
    launches += 1
    return qkv


def rope_qk_(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             heads: int) -> torch.Tensor:
    """Rotate q and k of the patch rows of the packed ``qkv`` [B, L, 3C] in
    place and return it: R1 on a CUDA device, the plain version on the CPU.

    On the card qkv must be bf16 or f32, contiguous and 16-byte aligned,
    with the head dim a multiple of 8 (bf16) or 4 (f32); cos and sin are
    [L-1, head dim] f32 on the same card.  R1 has no backward: on the card
    a ``qkv`` that requires a gradient raises."""
    B, L, C, hd = _shape(qkv, cos, sin, heads)
    if qkv.device.type == "cpu":
        return rope_qk_plain_(qkv, cos, sin, heads)
    if qkv.device.type != "cuda" or cos.device != qkv.device or sin.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, tables on {cos.device} / {sin.device}: "
                         "need all on one CUDA device")
    if qkv.dtype not in ENTRIES or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"R1 takes a bf16 or f32 qkv and f32 tables, got {qkv.dtype}, "
                        f"{cos.dtype}, {sin.dtype}")
    if not (qkv.is_contiguous() and cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("qkv and the tables must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    vec = 16 // qkv.element_size()
    if C % vec or hd % vec:
        raise ValueError(f"R1 moves {vec} elements a thread: C and the head dim must be "
                         "multiples of it")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("R1 has no backward: run the EVA02 tower under torch.no_grad()")
    return _launch(qkv, cos, sin, B, L, C, hd)
