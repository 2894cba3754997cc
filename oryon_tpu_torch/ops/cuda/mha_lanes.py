"""Fused multi-head attention on the lane-packed [B, L, 3C] layout (K1, and
K1-i8 with ``qk_int8=True``).

Counterpart of ``oryon_tpu/ops/pallas/mha_lanes.py``.  The kernel reads the
packed in_proj output directly (q | k | v along the last axis, heads packed
inside each), so no q/k/v split or head transpose is materialised.  The CUDA
source is ``oryon_tpu_torch/csrc/mha_lanes.cu``.

``fused_mha_lanes_qkv`` launches the kernel for a CUDA tensor and runs the
plain PyTorch version (``reference_mha``) for a CPU tensor.  Which kernel
serves which shape (``kernel_entry``):

- head dimension 64 with bf16 logits (K1 on the ViT-L tower): the wgmma
  kernel of ``csrc/attn_wgmma.cuh`` (S, P and O in registers, K and V tiles
  through a TMA ring), entry ``oryon_fused_mha_lanes_wgmma_bf16``;
- head dimensions 16, 32 and 128 with bf16 logits: the WMMA streaming kernel
  of ``csrc/attn_stream.cuh``, entry ``oryon_fused_mha_lanes_bf16``;
- ``qk_int8=True`` (K1-i8) at head dimension 64: a pre-pass that takes the
  per-(image, head) absmax and quantises q * scale and k once into an int8
  scratch, then the int8 mode of the wgmma kernel (``wgmma`` s8 x s8 -> s32
  for the logits), entry ``oryon_fused_mha_lanes_i8qk_wgmma_bf16``;
- ``qk_int8=True`` at head dimensions 16, 32 and 128: the WMMA streaming
  kernel with int8 logits (each block quantises the tiles it loads), entry
  ``oryon_fused_mha_lanes_i8qk_bf16``;
- an f32 qkv (the small and tiny towers) with L <= 128 at head dimensions 16
  and 32 (``F32_HEAD_MAX_L``, ``F32_HEAD_DIMS``; the towers run [B, 65, 192]
  and [B, 17, 192], 4 heads of 16): one block an (image, head), holding the
  head's whole attention, ``csrc/attn_f32_head.cuh``, entry
  ``oryon_fused_mha_lanes_f32_head``, with the TPU kernel's f32 arithmetic
  and order (the exact row maximum over all keys, f32 exponentials and sums,
  division last);
- an f32 qkv beyond that (longer L, head dimensions 64 and 128): the
  CUDA-core streaming kernel of ``csrc/attn_f32.cuh``, entry
  ``oryon_fused_mha_lanes_f32`` (a running maximum, rescaled per key tile).
  ``qk_int8`` takes bf16 only, as in the JAX package.  ``run_entry`` runs a
  named entry uncounted, e.g. the streaming kernel where the route takes the
  other, for timing.

Gradients: on a ``qkv`` that requires one (the towers under
``train_towers``), the call goes through ``MhaLanesFunction``: forward is the
kernel above, backward is K1's backward kernel (``backward_entry``), counted
on ``launches_bwd``:

- head dimension 64 in bf16 (the ViT-L tower): the wgmma + TMA kernels of
  ``csrc/attn_bwd_wgmma.cuh``, entry ``oryon_mha_lanes_bwd_wgmma_bf16``;
- head dimensions 16, 32 and 128 in bf16: the ``mma.sync`` kernels of
  ``csrc/attn_bwd.cuh``, entry ``oryon_mha_lanes_bwd_bf16``;
- f32 where the forward takes its one-block-a-head kernel: one launch, one
  block an (image, head), the five products with S, P and dS in shared
  memory, d kmask summed in the same launch by the last block to finish
  (``csrc/attn_bwd_f32_head.cuh``, entry ``oryon_mha_lanes_bwd_f32_head``;
  a [B * heads, L] slab and a counter a device, ``head_counter``, only when
  kmask needs a gradient);
- f32 beyond that: the CUDA-core kernels of ``csrc/attn_bwd.cuh``, entry
  ``oryon_mha_lanes_bwd_f32`` (two or three launches).
  It returns d qkv and, when kmask needs one, d kmask:
the JAX package's ``_bwd`` (``jax.vjp`` of its ``_reference_mha``),
straight-through for ``qk_int8`` (the gradient ignores the quantisation, so
both modes launch the same kernel).  On the CPU both directions run the
plain versions: ``reference_mha`` and ``reference_mha_backward`` (autograd
through ``reference_mha``).

``qk_int8=True`` forms the logits from int8 codes: per (image, head),
``q * scale`` and ``k`` are quantised by the absmax of their whole [L, hd]
slab (``round(x * (127 / max))``, half to even, max floored at 1e-12), the
products are summed in int32 and descaled by ``qm * km / 127**2``.  The
logits carry about 1% quantisation noise by design; the rest of the
attention is unchanged.
"""
from __future__ import annotations

import torch

from oryon_tpu_torch.ops.cuda import _lib

launches = 0      # K1 launches so far; callers may reset it to 0
launches_i8 = 0   # K1-i8 launches (pre-pass and main kernel count as one)
launches_bwd = 0  # K1 backward launches (its kernels count as one)
PREPASS, ATTEND = 1, 2   # phases of the head-dim-64 K1-i8 entry; both = 3
# phases of the head-dim-64 backward entry: the query-tile kernel (row
# statistics, dQ), the key-tile kernel (dK, dV, d kmask); both = 3
BWD_DQ, BWD_DKV = 1, 2
BWD_WGMMA = "oryon_mha_lanes_bwd_wgmma_bf16"
BWD_F32_HEAD = "oryon_mha_lanes_bwd_f32_head"
# the f32 shapes whose (image, head) one block holds whole, both directions
F32_HEAD_MAX_L, F32_HEAD_DIMS = 128, (16, 32)


def _quantise(q: torch.Tensor, k: torch.Tensor, scale: float):
    """(qm, km, qi, ki) on [B, H, L, hd] views: the absmax of q * scale and
    of k over each (image, head) slab, floored at 1e-12, [B, H, 1, 1] f32,
    and the codes round_half_even(x * (127 / max)) as f32 tensors."""
    qf = q.float() * scale
    kf = k.float()
    qm = qf.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-12)
    km = kf.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-12)
    # a true division, as the reference's and the kernels' 127 / max: a
    # number / tensor in PyTorch multiplies by the reciprocal instead, which
    # is one ulp off for some maxima and flips a code in ten thousand
    top = torch.full_like(qm, 127.0)
    return qm, km, torch.round(qf * (top / qm)), torch.round(kf * (top / km))


def _int8_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, H, L, L] f32 logits from per-(image, head) int8 codes of q * scale
    and k.  The codes go through an f32 matmul, which is exact here: every
    product is at most 127**2 and a sum of hd <= 128 of them stays below
    2**24 (TF32 must be off, as it is by default for matmuls)."""
    qm, km, qi, ki = _quantise(q, k, scale)
    si = torch.einsum("bhld,bhmd->bhlm", qi, ki)
    return si * (qm * km / (127.0 * 127.0))


def quantise_qk_plain(qkv: torch.Tensor, heads: int, scale: float):
    """Plain version of K1-i8's pre-pass: (absmax [B, heads, 2] f32 holding
    max|q * scale| and max|k| of each head, codes [B, L, 2C] int8 holding the
    codes of q * scale | k laid out as the first two thirds of a qkv row)."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    q, k = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
            for t in qkv.split(C, dim=-1)[:2])
    qm, km, qi, ki = _quantise(q, k, scale)
    codes = torch.cat([t.transpose(1, 2).reshape(B, L, C) for t in (qi, ki)], dim=-1)
    return torch.cat([qm, km], dim=-1).reshape(B, heads, 2), codes.to(torch.int8)


def reference_mha(qkv: torch.Tensor, kmask: torch.Tensor, heads: int,
                  scale: float, qk_int8: bool = False) -> torch.Tensor:
    """Plain version with the semantics of the JAX ``_reference_mha``:
    logits in the input dtype, softmax in f32, probabilities cast back;
    with ``qk_int8`` the logits of the JAX kernel's int8 branch."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    if qk_int8:
        s = _int8_logits(q, k, scale)
    else:
        s = torch.einsum("bhld,bhmd->bhlm", q, k).float() * scale
    s = s + kmask.float()[None, None, None, :]
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhlm,bhmd->bhld", p, v)
    return o.transpose(1, 2).reshape(B, L, C)


def _f32_head(head_dim: int, L) -> bool:
    """True where one block holds an f32 (image, head) whole."""
    if L is None:
        raise ValueError("an f32 qkv is routed by its length L too")
    return L <= F32_HEAD_MAX_L and head_dim in F32_HEAD_DIMS


def kernel_entry(head_dim: int, qk_int8: bool, dtype=torch.bfloat16, L=None) -> str:
    """The C entry point that serves this head dimension, dtype and (for f32)
    length L (see the module docstring)."""
    if head_dim not in (16, 32, 64, 128):
        raise ValueError(f"head dim {head_dim} not in (16, 32, 64, 128)")
    if dtype == torch.float32:
        if qk_int8:
            raise TypeError("qk_int8 takes a bf16 qkv")
        return ("oryon_fused_mha_lanes_f32_head" if _f32_head(head_dim, L)
                else "oryon_fused_mha_lanes_f32")
    if dtype != torch.bfloat16:
        raise TypeError(f"kernel takes a bf16 or f32 qkv, got {dtype}")
    if qk_int8:
        return ("oryon_fused_mha_lanes_i8qk_wgmma_bf16" if head_dim == 64
                else "oryon_fused_mha_lanes_i8qk_bf16")
    if head_dim == 64:
        return "oryon_fused_mha_lanes_wgmma_bf16"
    return "oryon_fused_mha_lanes_bf16"


def _i8_scratch(qkv: torch.Tensor, heads: int):
    """What K1-i8's pre-pass writes and its attention kernel reads: absmax
    [B, heads, 2] f32 and, at head dimension 64, the codes [B, L, 2C] int8."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    absmax = torch.empty((B, heads, 2), dtype=torch.float32, device=qkv.device)
    codes = torch.empty((B, L, 2 * C) if C // heads == 64 else (0,),
                        dtype=torch.int8, device=qkv.device)
    return absmax, codes


def run_i8_phases(qkv: torch.Tensor, kmask: torch.Tensor, heads: int, scale: float,
                  phases: int, absmax: torch.Tensor, codes: torch.Tensor,
                  out: torch.Tensor) -> None:
    """One or both phases of K1-i8 at head dimension 64 on a CUDA device, on
    scratch and output the caller holds (``_i8_scratch``): ``PREPASS`` fills
    absmax and codes, ``ATTEND`` reads them.  For holding and timing the
    phases apart; counts no launch and checks no argument."""
    B, L, C3 = qkv.shape
    err = _lib.library().oryon_fused_mha_lanes_i8qk_wgmma_bf16(
        qkv.data_ptr(), kmask.data_ptr(), absmax.data_ptr(), codes.data_ptr(),
        out.data_ptr(), B, L, C3 // 3, heads, float(scale), phases,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _lib.check(err, f"K1-i8 phases {phases}")


def _launch(lib, qkv: torch.Tensor, kmask: torch.Tensor, heads: int,
            scale: float, qk_int8: bool, stream: int) -> torch.Tensor:
    """Allocate the output, call the entry point for this shape on ``lib``
    and count the launch."""
    global launches, launches_i8
    B, L, C3 = qkv.shape
    C = C3 // 3
    fn = getattr(lib, kernel_entry(C // heads, qk_int8, qkv.dtype, L))
    out = torch.empty((B, L, C), dtype=qkv.dtype, device=qkv.device)
    if qk_int8:
        absmax, codes = _i8_scratch(qkv, heads)
        if C // heads == 64:
            err = fn(qkv.data_ptr(), kmask.data_ptr(), absmax.data_ptr(), codes.data_ptr(),
                     out.data_ptr(), B, L, C, heads, float(scale), PREPASS | ATTEND, stream)
        else:
            err = fn(qkv.data_ptr(), kmask.data_ptr(), absmax.data_ptr(), out.data_ptr(),
                     B, L, C, heads, float(scale), stream)
        _lib.check(err, "fused_mha_lanes_qkv(qk_int8=True)")
        launches_i8 += 1
    else:
        err = fn(qkv.data_ptr(), kmask.data_ptr(), out.data_ptr(), B, L, C, heads,
                 float(scale), stream)
        _lib.check(err, "fused_mha_lanes_qkv")
        launches += 1
    return out


def _forward(qkv: torch.Tensor, kmask: torch.Tensor, heads: int, scale: float,
             qk_int8: bool) -> torch.Tensor:
    """The kernel on a CUDA device, the plain version on the CPU."""
    C = qkv.shape[-1] // 3
    if qkv.device.type == "cpu":
        return reference_mha(qkv, kmask, heads, scale, qk_int8)
    if qkv.device.type != "cuda" or kmask.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, kmask on {kmask.device}: "
                         "need both on one CUDA device")
    if kmask.dtype != torch.float32:
        raise TypeError(f"kernel takes an f32 kmask, got {kmask.dtype}")
    if not (qkv.is_contiguous() and kmask.is_contiguous()):
        raise ValueError("qkv and kmask must be contiguous")
    # raises on a dtype or head dim without a kernel
    kernel_entry(C // heads, qk_int8, qkv.dtype, qkv.shape[1])
    return _launch(_lib.library(), qkv, kmask, heads, scale, qk_int8,
                   torch.cuda.current_stream(qkv.device).cuda_stream)


def run_entry(entry: str, qkv: torch.Tensor, kmask: torch.Tensor, heads: int,
              scale: float) -> torch.Tensor:
    """K1's output from a named entry without int8 logits (its arguments are
    ``oryon_fused_mha_lanes_f32``'s) on a CUDA device, e.g. the streaming f32
    kernel at a shape the route gives to the one-block-a-head kernel.  For
    holding and timing bodies apart; counts no launch and checks no
    argument."""
    B, L, C3 = qkv.shape
    out = torch.empty((B, L, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = getattr(_lib.library(), entry)(
        qkv.data_ptr(), kmask.data_ptr(), out.data_ptr(), B, L, C3 // 3, heads, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _lib.check(err, entry)
    return out


def backward_entry(head_dim: int, dtype=torch.bfloat16, L=None) -> str:
    """The C entry point of K1's backward for this head dimension, dtype and
    (for f32) length L (either ``qk_int8``: the gradient is
    straight-through)."""
    if head_dim not in (16, 32, 64, 128):
        raise ValueError(f"head dim {head_dim} not in (16, 32, 64, 128)")
    if dtype == torch.float32:
        return BWD_F32_HEAD if _f32_head(head_dim, L) else "oryon_mha_lanes_bwd_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"K1's backward takes a bf16 or f32 qkv, got {dtype}")
    return BWD_WGMMA if head_dim == 64 else "oryon_mha_lanes_bwd_bf16"


def reference_mha_backward(qkv: torch.Tensor, kmask: torch.Tensor, dout: torch.Tensor,
                           heads: int, scale: float, want_mask: bool):
    """Plain version of K1's backward: (d qkv, d kmask or None) by autograd
    through ``reference_mha`` with the input dtype's logits, as the JAX
    ``_bwd`` takes ``jax.vjp`` of its ``_reference_mha``."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        m = kmask.detach().requires_grad_(want_mask)
        out = reference_mha(x, m, heads, scale)
        grads = torch.autograd.grad(out, (x, m) if want_mask else (x,), dout)
    return grads[0], (grads[1] if want_mask else None)


def backward_stats(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The backward's scratch of row statistics (m, 1 / l, D), [3, B * heads
    * Lp] f32 with Lp = L rounded up to whole tiles of 64, as the head-dim-64
    entry keeps each (image, head)'s rows."""
    B, L, _ = qkv.shape
    return torch.empty((3, B * heads * -(-L // 64) * 64), dtype=torch.float32,
                       device=qkv.device)


_counters: dict = {}   # device -> the one-block-a-head backward's counter


def head_counter(device) -> torch.Tensor:
    """The counter of the one-block-a-head f32 backward on this device: one
    int32, allocated zeroed on first use; each launch that sums d kmask counts
    its blocks on it and leaves it at 0."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:   # "cuda" is the current card
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _counters:
        _counters[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[device]


def _call_backward(lib, entry: str, qkv: torch.Tensor, kmask: torch.Tensor,
                   dout: torch.Tensor, heads: int, scale: float, want_mask: bool,
                   stream: int, phases: int = BWD_DQ | BWD_DKV, stats=None):
    """Allocate d qkv, d kmask and the scratch and call ``entry`` on ``lib``:
    for the one-block-a-head entry a [B * heads, L] slab of sums of dS and
    the device's counter, only when kmask needs a gradient; for the others
    the row statistics (unless ``stats`` is given) and the per-(image, head)
    sums of dS (``phases`` for the head-dim-64 entry only)."""
    B, L, C3 = qkv.shape
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    if entry == BWD_F32_HEAD:
        dkmask = slab = counter = None
        if want_mask:
            dkmask = torch.empty((L,), **f32)
            slab = torch.empty((B * heads, L), **f32)
            counter = head_counter(qkv.device)
        ptr = [0 if t is None else t.data_ptr() for t in (slab, counter, dkmask)]
        _lib.check(lib.oryon_mha_lanes_bwd_f32_head(
            qkv.data_ptr(), kmask.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), *ptr, B, L,
            C3 // 3, heads, float(scale), stream), "K1 backward")
        return dqkv, dkmask
    if stats is None:
        stats = backward_stats(qkv, heads)
    colsum = torch.empty((B * heads, L), **f32)
    dkmask = torch.empty((L,), **f32) if want_mask else None
    args = [qkv.data_ptr(), kmask.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), colsum.data_ptr(), 0 if dkmask is None else dkmask.data_ptr(),
            B, L, C3 // 3, heads, float(scale)]
    if entry == BWD_WGMMA:
        args.append(phases)
    _lib.check(getattr(lib, entry)(*args, stream), "K1 backward")
    return dqkv, dkmask


def _launch_backward(lib, qkv: torch.Tensor, kmask: torch.Tensor, dout: torch.Tensor,
                     heads: int, scale: float, want_mask: bool, stream: int):
    """Call the backward entry for this shape on ``lib`` and count the
    launch."""
    global launches_bwd
    out = _call_backward(lib, backward_entry(qkv.shape[-1] // 3 // heads, qkv.dtype,
                                             qkv.shape[1]),
                         qkv, kmask, dout, heads, scale, want_mask, stream)
    launches_bwd += 1
    return out


def run_backward_entry(entry: str, qkv: torch.Tensor, kmask: torch.Tensor,
                       dout: torch.Tensor, heads: int, scale: float, want_mask: bool,
                       phases: int = BWD_DQ | BWD_DKV, stats=None):
    """(d qkv, d kmask or None) from a named backward entry on a CUDA
    device, e.g. the ``mma.sync`` body at head dimension 64 or the
    two-kernel f32 body at the small tower's shape, which no route takes,
    or some ``phases`` of the head-dim-64 entry.  ``stats`` (from
    ``backward_stats``) is the caller's scratch of row statistics: the
    key-tile kernel alone (``BWD_DKV``) reads what an earlier ``BWD_DQ``
    call wrote there.  For holding and timing bodies and kernels apart;
    counts no launch and checks no argument."""
    return _call_backward(_lib.library(), entry, qkv, kmask, dout, heads, scale, want_mask,
                          torch.cuda.current_stream(qkv.device).cuda_stream, phases, stats)


def _backward(qkv: torch.Tensor, kmask: torch.Tensor, dout: torch.Tensor, heads: int,
              scale: float, want_mask: bool):
    """The backward kernel on a CUDA device, the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return reference_mha_backward(qkv, kmask, dout, heads, scale, want_mask)
    if qkv.device.type != "cuda" or kmask.device != qkv.device or dout.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, kmask on {kmask.device}, dout on "
                         f"{dout.device}: need all on one CUDA device")
    if kmask.dtype != torch.float32 or dout.dtype != qkv.dtype:
        raise TypeError(f"K1's backward takes an f32 kmask and a dout in qkv's dtype "
                        f"{qkv.dtype}, got {kmask.dtype} and {dout.dtype}")
    if not (qkv.is_contiguous() and kmask.is_contiguous()):
        raise ValueError("qkv and kmask must be contiguous")
    # raises on a dtype or head dim without a kernel
    backward_entry(qkv.shape[-1] // 3 // heads, qkv.dtype, qkv.shape[1])
    return _launch_backward(_lib.library(), qkv, kmask, dout.contiguous(), heads, scale,
                            want_mask, torch.cuda.current_stream(qkv.device).cuda_stream)


class MhaLanesFunction(torch.autograd.Function):
    """K1 under autograd: forward ``_forward``, backward ``_backward`` (the
    same with either ``qk_int8``)."""

    @staticmethod
    def forward(ctx, qkv, kmask, heads: int, scale: float, qk_int8: bool):
        ctx.save_for_backward(qkv, kmask)
        ctx.heads, ctx.scale = heads, scale
        return _forward(qkv, kmask, heads, scale, qk_int8)

    @staticmethod
    def backward(ctx, grad_out):
        qkv, kmask = ctx.saved_tensors
        dqkv, dkmask = _backward(qkv, kmask, grad_out, ctx.heads, ctx.scale,
                                 ctx.needs_input_grad[1])
        return dqkv, dkmask, None, None, None


def fused_mha_lanes_qkv(qkv: torch.Tensor, kmask: torch.Tensor, heads: int,
                        scale: float, qk_int8: bool = False) -> torch.Tensor:
    """softmax(q_h k_h^T * scale + kmask) v_h for every head h; with
    ``qk_int8`` the logits come from int8 codes (see the module docstring).

    qkv: [B, L, 3C] packed in_proj output; kmask: [L] additive f32 (0 for
    real keys, -1e9 for padding).  Returns [B, L, C] in qkv's dtype.  On a
    CUDA device qkv must be bf16 (or f32 without ``qk_int8``) and contiguous
    with C / heads in {16, 32, 64, 128}; L needs no alignment.
    """
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, L, 3C] with "
                         f"C divisible by heads={heads}")
    L = qkv.shape[1]
    if kmask.shape != (L,):
        raise ValueError(f"kmask {tuple(kmask.shape)} != ({L},)")
    if torch.is_grad_enabled() and (qkv.requires_grad or kmask.requires_grad):
        return MhaLanesFunction.apply(qkv, kmask, heads, scale, qk_int8)
    return _forward(qkv, kmask, heads, scale, qk_int8)
