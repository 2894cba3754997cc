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
the CUDA kernels compute each window on its own, which gives the same
function because the off-diagonal terms are exactly zero after the softmax.
The CUDA source is ``oryon_tpu_torch/csrc/swin_attn.cu``.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``) for CPU tensors.  Neither takes a gradient, on either
device (``_lib.forward_only``: the backward raises): the JAX package's
kernels have no ``custom_vjp``, so a Swin tower trained through them raises
here too.  Which kernel serves which shape
(``kernel_entry``):

- head dimension 32 (every Swin variant) with windows of up to 64 tokens:
  the wgmma kernel of ``csrc/swin_wgmma.cuh`` (one warpgroup a (window,
  head), S, P and O in registers, q, k, v tiles through a TMA ring,
  persistent blocks), entries ``oryon_packed_window_attention_wgmma_bf16``
  and ``oryon_band_window_attention_wgmma_bf16``.  Each entry first runs a
  pre-pass, one small launch, that lays the bias out in the order the
  kernel's accumulator registers hold the logits (``bias_fragments_plain`` is
  its plain version), bf16 for K3 and f32 for K4;
- head dimensions 16 and 64: the WMMA kernel of ``csrc/swin_attn.cu``,
  entries ``oryon_packed_window_attention_bf16`` and
  ``oryon_band_window_attention_bf16``.
"""
from __future__ import annotations

import torch

from oryon_tpu_torch.ops.cuda import _lib

launches_packed = 0   # K3 launches so far; callers may reset it to 0
launches_band = 0     # K4 launches so far (pre-pass and main kernel count as one)
BIAS, ATTEND = 1, 2   # phases of the head-dim-32 entries; both = 3
TILE = 64             # rows and columns of the wgmma kernel's logit tile


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


def kernel_entry(head_dim: int, N: int, band: bool) -> str:
    """The C entry point that serves this head dimension and window size
    (see the module docstring)."""
    if head_dim not in (16, 32, 64):
        raise ValueError(f"head dim {head_dim} not in (16, 32, 64)")
    if N > TILE:
        raise ValueError(f"kernel takes windows of at most {TILE} tokens, got {N}")
    name = "oryon_band_window_attention" if band else "oryon_packed_window_attention"
    return name + ("_wgmma_bf16" if head_dim == 32 else "_bf16")


def _fragment_index():
    """(row, col) [8, 128, 4]: the element of a [64, 64] f32 wgmma accumulator
    that thread ``tid`` of the warpgroup holds in register ``4 * j + e``."""
    tid = torch.arange(128)
    e = torch.arange(4)
    row = ((tid // 32) * 16 + (tid % 32) // 4)[:, None] + 8 * (e >> 1)[None, :]
    col = (torch.arange(8) * 8)[:, None, None] + ((tid % 4) * 2)[None, :, None] \
        + (e & 1)[None, None, :]
    return row[None].expand(8, 128, 4), col


def bias_fragments_plain(bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the wgmma kernels' bias pre-pass: bias
    [nw, heads, N, N] padded to the [64, 64] logit tile (-inf in the pad
    columns, 0 in the pad rows) and laid out in the order the accumulator
    registers hold the logits, f32 [nw, heads, 8, 128, 4] (j, thread, e) or,
    rounded to bf16, [nw, heads, 4, 128, 8] (j / 2, thread, (j % 2, e))."""
    nw, heads, N, _ = bias.shape
    tile = torch.zeros((nw, heads, TILE, TILE), dtype=torch.float32, device=bias.device)
    tile[..., N:] = float("-inf")
    tile[:, :, :N, :N] = bias.float()
    row, col = (t.to(bias.device) for t in _fragment_index())
    frag = tile[:, :, row, col]
    if dtype == torch.bfloat16:
        frag = frag.to(torch.bfloat16).reshape(nw, heads, 4, 2, 128, 4).permute(
            0, 1, 2, 4, 3, 5).reshape(nw, heads, 4, 128, 8)
    elif dtype != torch.float32:
        raise TypeError(f"fragments are f32 or bf16, not {dtype}")
    return frag.contiguous()


def _frag_scratch(bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """What the pre-pass writes and the wgmma kernel reads."""
    nw, heads = bias.shape[:2]
    shape = (nw, heads, 8, 128, 4) if dtype == torch.float32 else (nw, heads, 4, 128, 8)
    return torch.empty(shape, dtype=dtype, device=bias.device)


def _check_cuda(tensors, bias: torch.Tensor, bias_dtype: torch.dtype) -> None:
    first = tensors[0]
    if first.device.type != "cuda" or any(t.device != first.device
                                           for t in (*tensors, bias)):
        raise ValueError("the inputs and the bias must lie on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors) or bias.dtype != bias_dtype:
        raise TypeError(f"kernel takes bf16 inputs and a {bias_dtype} bias, got "
                        f"{first.dtype} and {bias.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, bias)):
        raise ValueError("the inputs and the bias must be contiguous")


def run_packed_phases(q, k, v, bias, heads: int, scale: float, phases: int,
                      frag: torch.Tensor, out: torch.Tensor) -> None:
    """One or both phases of K3 at head dimension 32 on a CUDA device, on
    scratch and output the caller holds (``_frag_scratch(bias, bfloat16)``):
    ``BIAS`` fills the fragments from the f32 bias, ``ATTEND`` reads them.
    For holding and timing the phases apart; counts no launch and checks no
    argument."""
    Bw, N, C = q.shape
    err = _lib.library().oryon_packed_window_attention_wgmma_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), frag.data_ptr(),
        out.data_ptr(), Bw, bias.shape[0], N, C, heads, float(scale), phases,
        torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, f"K3 phases {phases}")


def run_band_phases(qkv_map, bias, heads: int, window: int, scale: float,
                    phases: int, frag: torch.Tensor, out: torch.Tensor) -> None:
    """The same for K4 (``_frag_scratch(bias, float32)``)."""
    B, Hp, Wp, C3 = qkv_map.shape
    err = _lib.library().oryon_band_window_attention_wgmma_bf16(
        qkv_map.data_ptr(), bias.data_ptr(), frag.data_ptr(), out.data_ptr(), B, Hp,
        Wp, C3 // 3, heads, window, float(scale), phases,
        torch.cuda.current_stream(qkv_map.device).cuda_stream)
    _lib.check(err, f"K4 phases {phases}")


def _launch_packed(lib, q, k, v, bias, heads: int, scale: float, stream: int
                   ) -> torch.Tensor:
    """Allocate the output (and the bias in the form the kernel reads), call
    the entry point for this shape on ``lib`` and count the launch."""
    global launches_packed
    Bw, N, C = q.shape
    entry = kernel_entry(C // heads, N, band=False)
    out = torch.empty_like(q)
    if entry.endswith("_wgmma_bf16"):
        bias32 = bias.float().contiguous()
        frag = _frag_scratch(bias32, torch.bfloat16)
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(), frag.data_ptr(),
            out.data_ptr(), Bw, bias.shape[0], N, C, heads, float(scale), BIAS | ATTEND,
            stream)
    else:
        bias16 = bias.to(torch.bfloat16).contiguous()
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias16.data_ptr(), out.data_ptr(),
            Bw, bias.shape[0], N, C, heads, float(scale), stream)
    _lib.check(err, "packed_window_attention")
    launches_packed += 1
    return out


def _launch_band(lib, qkv_map, bias, heads: int, window: int, scale: float,
                 stream: int) -> torch.Tensor:
    """The same for K4."""
    global launches_band
    B, Hp, Wp, C3 = qkv_map.shape
    C = C3 // 3
    entry = kernel_entry(C // heads, window * window, band=True)
    out = torch.empty((B, Hp, Wp, C), dtype=qkv_map.dtype, device=qkv_map.device)
    if entry.endswith("_wgmma_bf16"):
        frag = _frag_scratch(bias, torch.float32)
        err = getattr(lib, entry)(
            qkv_map.data_ptr(), bias.data_ptr(), frag.data_ptr(), out.data_ptr(), B, Hp,
            Wp, C, heads, window, float(scale), BIAS | ATTEND, stream)
    else:
        err = getattr(lib, entry)(
            qkv_map.data_ptr(), bias.data_ptr(), out.data_ptr(), B, Hp, Wp, C, heads,
            window, float(scale), stream)
    _lib.check(err, "band_window_attention")
    launches_band += 1
    return out


def packed_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, heads: int, scale: float
                            ) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per window and head.

    q, k, v: [Bw, N, C] with Bw = images * nw, the windows of one image
    consecutive; bias: [nw, heads, N, N] additive, any float dtype (it is
    rounded to bf16).  Returns [Bw, N, C] in q's dtype.  On a CUDA device
    q, k, v must be bf16 and contiguous, C / heads in {16, 32, 64}, N <= 64.
    """
    if (q.dim() != 3 or k.shape != q.shape or v.shape != q.shape
            or q.shape[-1] % heads):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not three [Bw, N, C] with C "
                         f"divisible by heads={heads}")
    Bw, N, C = q.shape
    if bias.dim() != 4 or bias.shape[1:] != (heads, N, N) or Bw % bias.shape[0]:
        raise ValueError(f"bias {tuple(bias.shape)} is not [nw, {heads}, {N}, "
                         f"{N}] with nw dividing Bw={Bw}")
    return _lib.forward_only("packed_window_attention (K3, Swin attn_impl=pallas)",
                             lambda *t: _packed(*t, heads, scale), q, k, v, bias)


def _packed(q, k, v, bias, heads: int, scale: float) -> torch.Tensor:
    _, N, C = q.shape
    if q.device.type == "cpu":
        return packed_window_attention_plain(q, k, v, bias, heads, scale)
    if not bias.is_floating_point():
        raise TypeError(f"bias is {bias.dtype}, not a float type")
    _check_cuda((q, k, v), bias, bias.dtype)
    kernel_entry(C // heads, N, band=False)   # raises on a shape without a kernel
    return _launch_packed(_lib.library(), q, k, v, bias, heads, scale,
                          torch.cuda.current_stream(q.device).cuda_stream)


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
    return _lib.forward_only("band_window_attention (K4, Swin attn_impl=band)",
                             lambda *t: _band(*t, heads, window, scale), qkv_map, bias)


def _band(qkv_map, bias, heads: int, window: int, scale: float) -> torch.Tensor:
    C, N = qkv_map.shape[-1] // 3, window * window
    if qkv_map.device.type == "cpu":
        return band_window_attention_plain(qkv_map, bias, heads, window, scale)
    _check_cuda((qkv_map,), bias, torch.float32)
    kernel_entry(C // heads, N, band=True)   # raises on a shape without a kernel
    return _launch_band(_lib.library(), qkv_map, bias, heads, window, scale,
                        torch.cuda.current_stream(qkv_map.device).cuda_stream)
