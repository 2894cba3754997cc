"""Swin window attention kernels (K3 packed windows, K4 map-level "band").

Counterpart of ``oryon_tpu/ops/pallas/swin_attn.py``.  Both compute
softmax(q k^T * scale + bias) v inside each window of N = w*w tokens, per
head, with bias [nw, heads, N, N] = relative-position bias + shift mask:

* ``packed_window_attention`` takes window-partitioned q, k, v [Bw, N, C]
  and rounds the bias to bf16 before adding it in f32, as the reference does;
* ``band_window_attention`` takes the padded (and, for shifted blocks,
  rolled) qkv map [B, Hp, Wp, 3C] and returns [B, Hp, Wp, C]: the window
  partition and reverse happen inside the kernel; the bias stays f32.

The TPU kernels' ``pack`` argument (how many windows share one
block-diagonal product, to fill the TPU's matrix unit) has no counterpart:
the CUDA kernel computes each window on its own, which gives the same
function because the off-diagonal terms are exactly zero after the softmax.
The CUDA source is ``oryon_tpu_torch/csrc/swin_attn.cu``.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``) for CPU tensors.
"""
from __future__ import annotations

import torch

from oryon_tpu_torch.ops.cuda import _lib

launches_packed = 0   # K3 launches so far; callers may reset it to 0
launches_band = 0     # K4 launches so far


def _window_attention(q, k, v, bias, heads: int, scale: float,
                      images_per_chunk: int = 4) -> torch.Tensor:
    """The attention both plain versions share: q, k, v [Bw, N, C], bias
    [nw, heads, N, N] f32.  f32 logits from the inputs' exact products,
    softmax in f32 normalised before the cast to the input dtype, f32 sums
    in the P V product.  Runs a few images at a time so the f32 logits of
    the whole batch never exist at once."""
    Bw, N, C = q.shape
    nw = bias.shape[0]
    hd = C // heads
    out = torch.empty_like(q)
    step = nw * images_per_chunk
    for lo in range(0, Bw, step):
        qh, kh, vh = (t[lo:lo + step].reshape(-1, nw, N, heads, hd)
                      .permute(0, 1, 3, 2, 4).float() for t in (q, k, v))
        s = torch.einsum("bwhnd,bwhmd->bwhnm", qh, kh) * scale + bias[None]
        prob = torch.softmax(s, dim=-1).to(q.dtype).float()
        o = torch.einsum("bwhnm,bwhmd->bwhnd", prob, vh)
        out[lo:lo + step] = o.permute(0, 1, 3, 2, 4).reshape(-1, N, C).to(q.dtype)
    return out


def packed_window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, bias: torch.Tensor,
                                  heads: int, scale: float) -> torch.Tensor:
    """Plain version of ``packed_window_attention`` (bias rounded to bf16)."""
    return _window_attention(q, k, v, bias.to(torch.bfloat16).float(), heads, scale)


def band_window_attention_plain(qkv_map: torch.Tensor, bias: torch.Tensor,
                                heads: int, window: int, scale: float
                                ) -> torch.Tensor:
    """Plain version of ``band_window_attention``: partition the map into
    windows, attend with the f32 bias, and put the windows back."""
    B, Hp, Wp, C3 = qkv_map.shape
    C, w = C3 // 3, window
    wins = qkv_map.reshape(B, Hp // w, w, Wp // w, w, C3).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, w * w, C3)
    q, k, v = wins.split(C, dim=-1)
    out = _window_attention(q, k, v, bias.float(), heads, scale)
    return out.reshape(B, Hp // w, Wp // w, w, w, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)


def _check_cuda(tensors, bias: torch.Tensor, bias_dtype: torch.dtype,
                hd: int, N: int) -> None:
    first = tensors[0]
    if first.device.type != "cuda" or any(t.device != first.device
                                           for t in (*tensors, bias)):
        raise ValueError("the inputs and the bias must lie on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors) or bias.dtype != bias_dtype:
        raise TypeError(f"kernel takes bf16 inputs and a {bias_dtype} bias, got "
                        f"{first.dtype} and {bias.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, bias)):
        raise ValueError("the inputs and the bias must be contiguous")
    if hd not in (16, 32, 64):
        raise ValueError(f"head dim {hd} not in (16, 32, 64)")
    if N > 64:
        raise ValueError(f"kernel takes windows of at most 64 tokens, got {N}")


def packed_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, heads: int, scale: float
                            ) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per window and head.

    q, k, v: [Bw, N, C] with Bw = images * nw, the windows of one image
    consecutive; bias: [nw, heads, N, N] additive, any float dtype (it is
    rounded to bf16).  Returns [Bw, N, C] in q's dtype.  On a CUDA device
    q, k, v must be bf16 and contiguous, C / heads in {16, 32, 64}, N <= 64.
    """
    global launches_packed
    if (q.dim() != 3 or k.shape != q.shape or v.shape != q.shape
            or q.shape[-1] % heads):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not three [Bw, N, C] with C "
                         f"divisible by heads={heads}")
    Bw, N, C = q.shape
    if bias.dim() != 4 or bias.shape[1:] != (heads, N, N) or Bw % bias.shape[0]:
        raise ValueError(f"bias {tuple(bias.shape)} is not [nw, {heads}, {N}, "
                         f"{N}] with nw dividing Bw={Bw}")
    if q.device.type == "cpu":
        return packed_window_attention_plain(q, k, v, bias, heads, scale)
    bias16 = bias.to(torch.bfloat16).contiguous()
    _check_cuda((q, k, v), bias16, torch.bfloat16, C // heads, N)
    out = torch.empty_like(q)
    lib = _lib.library()
    err = lib.oryon_packed_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias16.data_ptr(),
        out.data_ptr(), Bw, bias.shape[0], N, C, heads, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "packed_window_attention")
    launches_packed += 1
    return out


def band_window_attention(qkv_map: torch.Tensor, bias: torch.Tensor,
                          heads: int, window: int, scale: float) -> torch.Tensor:
    """The same attention read straight off the feature map.

    qkv_map: [B, Hp, Wp, 3C] (q | k | v along the last axis), Hp and Wp
    multiples of ``window``, already padded and (for shifted blocks) rolled;
    bias: [nw, heads, N, N] f32 with nw row-major over the (Hp/window,
    Wp/window) grid of windows.  Returns [B, Hp, Wp, C].  On a CUDA device
    the map must be bf16 and contiguous, the bias f32, C / heads in
    {16, 32, 64} and window <= 8.
    """
    global launches_band
    if qkv_map.dim() != 4 or qkv_map.shape[-1] % 3 or (qkv_map.shape[-1] // 3) % heads:
        raise ValueError(f"qkv_map {tuple(qkv_map.shape)} is not [B, Hp, Wp, 3C] "
                         f"with C divisible by heads={heads}")
    B, Hp, Wp, C3 = qkv_map.shape
    C, N = C3 // 3, window * window
    if Hp % window or Wp % window:
        raise ValueError(f"map {Hp} x {Wp} is not a multiple of window {window}")
    nw = (Hp // window) * (Wp // window)
    if bias.shape != (nw, heads, N, N):
        raise ValueError(f"bias {tuple(bias.shape)} != ({nw}, {heads}, {N}, {N})")
    if qkv_map.device.type == "cpu":
        return band_window_attention_plain(qkv_map, bias, heads, window, scale)
    _check_cuda((qkv_map,), bias, torch.float32, C // heads, N)
    out = torch.empty((B, Hp, Wp, C), dtype=qkv_map.dtype, device=qkv_map.device)
    lib = _lib.library()
    err = lib.oryon_band_window_attention_bf16(
        qkv_map.data_ptr(), bias.data_ptr(), out.data_ptr(), B, Hp, Wp, C,
        heads, window, float(scale),
        torch.cuda.current_stream(qkv_map.device).cuda_stream)
    _lib.check(err, "band_window_attention")
    launches_band += 1
    return out
