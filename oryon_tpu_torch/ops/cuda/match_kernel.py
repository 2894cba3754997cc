"""Masked cosine argmin for nearest-neighbour matching (K2).

One wrapper, two modes, each the counterpart of one JAX function:

- ``precision="fp32"``: ``oryon_tpu/ops/pallas/match_kernel.py::
  masked_argmin_pallas``, whose products are taken at ``Precision.HIGHEST``
  on the f32 inputs (and ``oryon_tpu/ops/matching.py::_streaming_argmin`` in
  its fp32 mode, the strict-parity runs).  The Pallas kernel adds +1e9 to an
  excluded target where this port uses +inf: the same argmin whenever a pair
  keeps a target; a pair that keeps none gives (+inf, 0) here, as in
  ``_streaming_argmin``.
- ``precision="bf16"`` (inputs rounded to bf16, f32 sums; the serving
  default): ``_streaming_argmin`` in its bf16 mode.

``masked_argmin`` launches a kernel for CUDA tensors and runs the plain
PyTorch version (``masked_argmin_plain``) for CPU tensors.  Both modes run a
pre-pass that compacts the non-excluded targets of each pair, in index order,
beside an index map and a per-pair count, then a tensor-core kernel
(``wgmma``, the running best on the accumulator registers) over ``splits``
ranges of each pair's targets and a small merge of the ranges; the count
stays in device memory, so nothing synchronises with the host between the
launches.  Which kernel serves which mode (``kernel_entry``):

- ``"bf16"``: rows rounded to bf16 (``compact_targets_plain`` is the
  pre-pass's plain version), ``wgmma`` m64n128k16, entry
  ``oryon_masked_argmin_wgmma_bf16`` (``csrc/match_wgmma.cuh``);
- ``"fp32"``: each kept row split into TF32 hi and lo parts
  (``split_tf32_plain``), every product taken as the three TF32 products
  hi·lo + lo·hi + hi·hi, ``wgmma`` m64n128k8 tf32, entry
  ``oryon_masked_argmin_wgmma_tf32x3`` (``csrc/match_tf32.cuh``).  The split
  keeps about 22 bits of each input, so the sums lie within about 1e-7 of
  f32 ones, against this mode's gate of 1e-5; one TF32 product would not
  hold it.

A failed build or launch raises; no route falls back to another kernel or to
the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from oryon_tpu_torch.ops.cuda import _lib

launches = 0        # bf16-mode launches so far (pre-pass and main kernel count
                    # as one); callers may reset it to 0
launches_fp32 = 0   # the same for the fp32 mode
PRECISIONS = ("bf16", "fp32")
COMPACT, REDUCE = 1, 2   # phases of a mode's entry; both = 3
ENTRIES = {"bf16": "oryon_masked_argmin_wgmma_bf16",
           "fp32": "oryon_masked_argmin_wgmma_tf32x3"}


def _round_inputs(x: torch.Tensor, precision: str) -> torch.Tensor:
    # bf16 inputs with exact products and f32 accumulation == bf16-rounded
    # f32 inputs through an f32 matmul
    return x.bfloat16().float() if precision == "bf16" else x.float()


def masked_argmin_plain(src: torch.Tensor, tgt: torch.Tensor,
                        tgt_bad: torch.Tensor, precision: str = "bf16",
                        chunk: int = 4608) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version following ``_streaming_argmin``: targets in chunks, a
    running (min, argmin) and strict ``<`` across chunks, so the full
    source x target matrix is never built.  In fp32 mode on the card the
    matmuls are full f32 while TF32 stays off (PyTorch's default, which
    ``infer.full_precision_matmuls`` keeps)."""
    src = _round_inputs(src, precision)
    tgt = _round_inputs(tgt, precision)
    P, S, _ = src.shape
    N = tgt.shape[1]
    run_min = torch.full((P, S), float("inf"), device=src.device)
    run_arg = torch.zeros((P, S), dtype=torch.int32, device=src.device)
    for base in range(0, N, chunk):
        t = tgt[:, base:base + chunk]
        dist = 0.5 * (1.0 - torch.matmul(src, t.transpose(1, 2)))
        dist = dist.masked_fill(tgt_bad[:, None, base:base + chunk], float("inf"))
        cmin, carg = dist.min(dim=-1)
        better = cmin < run_min
        run_min = torch.where(better, cmin, run_min)
        run_arg = torch.where(better, carg.to(torch.int32) + base, run_arg)
    return run_min, run_arg


def compact_targets_plain(tgt: torch.Tensor, tgt_bad: torch.Tensor):
    """Plain version of the bf16 kernel's pre-pass: (tgt16 [P, N, D] bf16
    with the non-excluded rows of each pair first, in index order; idx_map
    [P, N] int32, the original index of each kept row; counts [P] int32).
    Rows and map entries at or past a pair's count are zeros here and not
    written by the kernel."""
    P, N, _ = tgt.shape
    tgt16 = torch.zeros(tgt.shape, dtype=torch.bfloat16, device=tgt.device)
    idx_map = torch.zeros((P, N), dtype=torch.int32, device=tgt.device)
    counts = (~tgt_bad).sum(dim=1).to(torch.int32)
    for p in range(P):
        kept = torch.nonzero(~tgt_bad[p]).flatten()
        tgt16[p, :kept.numel()] = tgt[p, kept].bfloat16()
        idx_map[p, :kept.numel()] = kept.to(torch.int32)
    return tgt16, idx_map, counts


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 bits of mantissa, to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``'s rounding) by the fp32 kernel's integer
    operations on the bit pattern (``csrc/match_wgmma.cuh``: round_tf32):
    add half a TF32 unit to the magnitude, clear the low 13 bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 kernel's split of f32 ``x``: (hi, lo) with
    hi = tf32(x) and lo = tf32(x - hi) (the difference is exact in f32), so
    |x - hi - lo| <= 2^-22 |x|."""
    hi = _round_tf32(x)
    return hi, _round_tf32(x.float() - hi)


def kernel_entry(precision: str) -> str:
    """The C entry point that serves this mode (see the module docstring)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return ENTRIES[precision]


def target_splits(P: int, S: int, N: int, sm_count: int) -> int:
    """Into how many ranges a mode's kernel splits each pair's targets.  A
    block owns 128 source rows of one range and an SM holds two blocks; the
    ranges make the grid at least twice the resident blocks, so that the
    last wave is short next to the whole (more ranges cost more than they
    level: every range starts its running best anew), but no range shorter
    than eight tiles of 128 targets."""
    blocks = P * (-(-S // 128))
    wanted = -(-2 * 2 * sm_count // blocks)
    longest = max(1, -(-N // 128) // 8)
    return max(1, min(wanted, longest))


def _scratch(src: torch.Tensor, tgt: torch.Tensor, precision: str = "bf16"):
    """What the phases of a mode's kernel hand each other: from the pre-pass
    the kept rows (bf16: [P, N, D] bf16; fp32: [P, 2, N, D] f32, the TF32 hi
    parts of pair p in [p, 0] and the lo parts in [p, 1]), idx_map [P, N]
    int32 and counts [P] int32; from the main kernel to its merge part_best
    [P, splits, S] f32 and part_pos [P, splits, S] int32."""
    P, N, D = tgt.shape
    S = src.shape[1]
    sm_count = (torch.cuda.get_device_properties(tgt.device).multi_processor_count
                if tgt.device.type == "cuda" else 1)
    splits = target_splits(P, S, N, sm_count)
    rows = (torch.empty((P, N, D), dtype=torch.bfloat16, device=tgt.device)
            if precision == "bf16" else
            torch.empty((P, 2, N, D), dtype=torch.float32, device=tgt.device))
    return (rows,
            torch.empty((P, N), dtype=torch.int32, device=tgt.device),
            torch.empty((P,), dtype=torch.int32, device=tgt.device),
            torch.empty((P, splits, S), dtype=torch.float32, device=tgt.device),
            torch.empty((P, splits, S), dtype=torch.int32, device=tgt.device))


def run_phases(src: torch.Tensor, tgt: torch.Tensor, tgt_bad: torch.Tensor,
               phases: int, scratch, out_min: torch.Tensor, out_arg: torch.Tensor,
               precision: str = "bf16") -> None:
    """One or both phases of a mode's kernel on a CUDA device, on scratch
    (``_scratch`` of the same mode) and outputs the caller holds:
    ``COMPACT`` fills the pre-pass's scratch, ``REDUCE`` reads it (main
    kernel, then merge).  For holding and timing the phases apart; counts no
    launch and checks no argument."""
    err = _call(_lib.library(), kernel_entry(precision), src, tgt, tgt_bad, scratch,
                out_min, out_arg, phases, torch.cuda.current_stream(src.device).cuda_stream)
    _lib.check(err, f"masked_argmin {precision} phases {phases}")


def _call(lib, entry: str, src, tgt, tgt_bad, scratch, out_min, out_arg, phases: int,
          stream: int) -> int:
    P, S, D = src.shape
    return getattr(lib, entry)(
        src.data_ptr(), tgt.data_ptr(), tgt_bad.data_ptr(),
        *(t.data_ptr() for t in scratch), out_min.data_ptr(), out_arg.data_ptr(),
        P, S, tgt.shape[1], D, scratch[3].shape[1], phases, stream)


def _launch(lib, src: torch.Tensor, tgt: torch.Tensor, tgt_bad: torch.Tensor,
            precision: str, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs and the mode's scratch, call the mode's entry
    point on ``lib`` (both phases) and count the launch."""
    global launches, launches_fp32
    P, S, D = src.shape
    out_min = torch.empty((P, S), dtype=torch.float32, device=src.device)
    out_arg = torch.empty((P, S), dtype=torch.int32, device=src.device)
    err = _call(lib, kernel_entry(precision), src, tgt, tgt_bad, _scratch(src, tgt, precision),
                out_min, out_arg, COMPACT | REDUCE, stream)
    _lib.check(err, f"masked_argmin({precision})")
    if precision == "bf16":
        launches += 1
    else:
        launches_fp32 += 1
    return out_min, out_arg


def _on_card(src: torch.Tensor, tgt: torch.Tensor, tgt_bad: torch.Tensor,
             precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel library (built at first use; a failed build raises), then
    the mode's launch on the current stream."""
    lib = _lib.library()
    return _launch(lib, src, tgt, tgt_bad, precision,
                   torch.cuda.current_stream(src.device).cuda_stream)


def masked_argmin(src: torch.Tensor, tgt: torch.Tensor, tgt_bad: torch.Tensor,
                  precision: str = "bf16") -> Tuple[torch.Tensor, torch.Tensor]:
    """(min [P, S] f32, argmin [P, S] int32) of 0.5 * (1 - <src, tgt>) over
    the targets of each pair, excluded targets at +inf; ties go to the
    lowest index; a pair with every target excluded gives (+inf, 0).

    src: [P, S, D] and tgt: [P, N, D] unit-normalised f32 features;
    tgt_bad: [P, N] bool, True where the target is excluded.  On a CUDA
    device D must be 32 and every tensor contiguous.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if (src.dim() != 3 or tgt.dim() != 3 or src.shape[0] != tgt.shape[0]
            or src.shape[2] != tgt.shape[2]
            or tgt_bad.shape != tgt.shape[:2]):
        raise ValueError(f"shapes src {tuple(src.shape)}, tgt "
                         f"{tuple(tgt.shape)}, tgt_bad {tuple(tgt_bad.shape)} "
                         "are not [P, S, D], [P, N, D], [P, N]")
    if src.device.type == "cpu":
        return masked_argmin_plain(src, tgt, tgt_bad, precision)
    if src.device.type != "cuda" or not (tgt.device == tgt_bad.device == src.device):
        raise ValueError("src, tgt and tgt_bad must lie on one CUDA device")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32 \
            or tgt_bad.dtype != torch.bool:
        raise TypeError("kernel takes f32 src/tgt and bool tgt_bad")
    if not (src.is_contiguous() and tgt.is_contiguous()
            and tgt_bad.is_contiguous()):
        raise ValueError("src, tgt and tgt_bad must be contiguous")
    if src.shape[2] != 32:
        raise ValueError(f"kernel takes D=32 features, got {src.shape[2]}")
    return _on_card(src, tgt, tgt_bad, precision)
