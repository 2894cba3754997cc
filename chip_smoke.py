#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (oryon_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --kernels  # device, build and the kernel phases only
    python3 chip_smoke.py --profile DIR  # + one profiled batch, tables in DIR

Phases, each printing one line with its result and its time:
  1. device    the card (torch and nvidia-smi); fails without CUDA
  2. build     nvcc builds the kernels from oryon_tpu_torch/csrc/; the
               machine code of the wgmma kernels holds tensor-core (HGMMA;
               IGMMA for K1-i8's int8 logits) and TMA-load instructions
  3. k1        fused attention kernel (wgmma, head dim 64) vs its plain
               version at the ViT-L shape and at the edges of its tiling
               (L = 640, 65, 1, one image, a fully masked leading key tile),
               one head-dim-32 case on the WMMA kernel, two launches bitwise
               equal, and the host time of one wrapper call
  4. k1i8      the same with int8 logits (int8 wgmma behind a quantising
               pre-pass) at the padded ViT-L shape and the same edges; the
               pre-pass alone gives the plain version's absmax and int8 codes
               exactly; pre-pass and attention kernel timed apart
  5. k5        flash attention on [B, H, L, D] with segment ids, the same
               edges and a head-dim-32 case
  6. k3, k4    Swin window attention, packed windows and map-level, at both
               Swin-B stages with a shifted-window mask in the bias
  7. k2        masked-argmin kernels vs their plain version at the serving
               shape: fp32 (CUDA cores) and bf16 (compacting pre-pass + wgmma),
               40% and 95% of the targets excluded, ragged sizes, pairs with
               all / all but one / no target excluded, duplicated targets; the
               pre-pass against torch.nonzero; pre-pass and main kernel timed
               apart
  8. register  Kabsch, RANSAC, PointDSC and ICP recover a known rigid
               transform in full f32 (catches TF32 in the pose math)
  9. serve     full_oryon(quant="int8") + PointDSC + ICP behind
               OryonPredictor at B=8 answers 12 requests; launch counters
               show the main path went through K1 and K2
 10. serve_optin  the same predictor switched to (fused_i8qk, Swin band) and
               to (flash, Swin pallas): one counted batch of 8 each, through
               K1-i8 + K4 and K5 + K3
Every kernel phase holds the kernel against its plain PyTorch version on the
same inputs and times kernel, plain version and, where one PyTorch call
computes the same function, that call (a yardstick only: the port never calls
it).  Then one JSON line of per-kernel results, the nvidia-smi name/power
line, and last the result line {"ok": true, "device": {...}}.  Any failure
exits non-zero before the result line.  Weights and inputs are random, from
seeds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

K1_SHAPE = (16, 577, 3 * 1024)    # 2B images x (CLS + 24^2 tokens) x 3C, ViT-L
K1_HEADS, K1_REAL = 16, 560       # keys >= K1_REAL carry the -1e9 pad mask
K1_PADDED = 640                   # the tower pads 577 -> 640 for fused_i8qk and flash
K2_PAIRS, K2_SRC, K2_TGT = 8, 5120, 192 * 192
# Swin-B on 16 images at 384^2: (padded map side, channels, heads) per stage
SWIN_STAGES = ((98, 128, 4), (49, 256, 8))
SWIN_IMAGES, SWIN_WINDOW = 16, 7
KERNEL_TOL = 2e-2                 # bf16 outputs: about one ulp at |x| in [2, 4)
# published dense peaks of one H100 SXM: bytes/s of HBM3, operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
ROT_TOL, TRANS_TOL = 1e-3, 1e-4   # registration: rad, m
TIMED_LAUNCHES = 20               # per kernel timing run (K2's CUDA-core kernel: 3)
TIMED_BATCHES = 3                 # warm B=8 batches timed for pairs/s
DEVICE = "cuda"                   # the CPU rehearsal sets "cpu"


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase(name: str):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                res = fn(*a, **kw)
            except Exception as e:
                print(f"[{name}] FAIL after {time.perf_counter() - t0:.1f} s: "
                      f"{type(e).__name__}: {e}", flush=True)
                raise
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {res['line']}",
                  flush=True)
            return res
        return run
    return deco


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events, after
    two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(kernel, plain, iters: int):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of the bytes moved once
    over the memory rate and the operations (by type) over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(torch, got, ref, what: str) -> float:
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), f"{what}: kernel output not finite")
    check(np.isfinite(err) and err < KERNEL_TOL,
          f"{what}: max |kernel - plain| = {err} >= {KERNEL_TOL}")
    return err


def timed(kernel, plain, library, iters: int) -> dict:
    ms, plain_ms = alternate(kernel, plain, iters)
    return {"ms": ms, "plain_ms": plain_ms,
            "library_ms": None if library is None else cuda_ms(library, iters)}


def times_txt(r: dict) -> str:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
    return (f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def host_us(fn, calls: int = 200) -> float:
    """Host time of one fn() call in microseconds: the enqueue alone, the
    clock read before any synchronise."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def same_twice(torch, fn, what: str) -> None:
    """Two launches on the same inputs give bitwise the same output."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    check(bool(torch.equal(a, b)), f"{what}: two launches differ")


def sdpa_packed(torch, qkv, mask, heads):
    """One library call for attention on packed [B, L, 3C] rows: strided head
    views into scaled_dot_product_attention, additive mask broadcast."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return out.transpose(1, 2).reshape(B, L, C)


@phase("device")
def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    check(cap >= (9, 0), f"{name} is sm_{cap[0]}{cap[1]}; the kernels target sm_90a")
    smi_line = smi.stdout.strip().splitlines()[0]
    return {"line": f"{name}, {torch.cuda.device_count()} device(s), torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}; "
                    f"nvidia-smi: {smi_line}",
            "name": name, "smi": smi_line}


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG")   # bf16 wgmma, int8 wgmma, TMA tile load


def _sass_counts(nvcc: str, lib_path: str):
    """Per wgmma kernel in the built library (the attention kernel's three
    modes and the matcher's), how many instructions of each of SASS_OPS its
    machine code holds; None where the toolkit has no cuobjdump."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[:300]}")
    counts = {}
    for chunk in out.stdout.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "attn_wgmma_kernel" in name or "match_wgmma_kernel" in name:
            counts[name] = tuple(chunk.count(op) for op in SASS_OPS)
    return counts


@phase("build")
def phase_build():
    from oryon_tpu_torch.ops.cuda import _lib
    _lib.library()
    info = _lib.build_info
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"    ptxas: {ln}")
    line = f"{info['path']} (nvcc {info['seconds']:.1f} s)"
    sass = _sass_counts(_lib._nvcc(), info["path"])
    if sass is not None:
        # attn_wgmma_kernel<mode, ...>: 0 K1, 1 K5, 2 K1-i8 (int8 Q K^T, bf16
        # P V); match_wgmma_kernel: K2.  All load their tiles by TMA.
        want = {"K1": ("attn_wgmma_kernelILi0E", ("HGMMA",)),
                "K5": ("attn_wgmma_kernelILi1E", ("HGMMA",)),
                "K1-i8": ("attn_wgmma_kernelILi2E", ("HGMMA", "IGMMA")),
                "K2": ("match_wgmma_kernel", ("HGMMA",))}
        check(len(sass) == len(want), f"wgmma kernels in the library: {sorted(sass)}")
        found = {}
        for label, (key, ops) in want.items():
            hits = [c for name, c in sass.items() if key in name]
            check(len(hits) == 1, f"{label}: {len(hits)} kernels named {key} in the library")
            got = dict(zip(SASS_OPS, hits[0]))
            check(all(got[op] > 0 for op in ops + ("UTMALDG",))
                  and (got["IGMMA"] == 0 or "IGMMA" in ops),
                  f"{label}: SASS instruction counts {got}, expected {ops} and UTMALDG")
            found[label] = hits[0]
        line += f"; wgmma kernels' SASS ({'/'.join(SASS_OPS)}): " + ", ".join(
            f"{label} {'/'.join(map(str, c))}" for label, c in found.items())
    return {"line": line}


# Edges of the wgmma kernel's tiling (64 query rows a warpgroup, key tiles of
# 64), at the tower's width: (images, L, head dim, first padded key, keys 0-63
# masked too).  The head-dim-32 case runs the WMMA kernel.
K1_EDGES = (("L=640 unpadded", 2, 640, 64, 640, False), ("L=65", 2, 65, 64, 65, False),
            ("L=1", 2, 1, 64, 1, False), ("B=1", 1, 577, 64, 560, False),
            ("masked leading tile", 2, 640, 64, 577, True))
K1_OTHER_HD = ("hd=32", 2, 577, 32, 560, False)


def _k1_case(torch, mha_lanes, g, B, L, hd, real, lead, qk_int8=False):
    qkv = torch.randn((B, L, 3 * K1_HEADS * hd), generator=g, device=DEVICE).to(torch.bfloat16)
    kmask = torch.where(torch.arange(L, device=DEVICE) < real, 0.0, -1e9)
    if lead:
        kmask[:64] = -1e9
    scale = hd ** -0.5
    return (mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale, qk_int8),
            mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale, qk_int8))


@phase("k1")
def phase_k1(torch, iters):
    from oryon_tpu_torch.ops.cuda import mha_lanes
    g = torch.Generator(device=DEVICE).manual_seed(1)
    B, L, C3 = K1_SHAPE
    qkv = torch.randn(K1_SHAPE, generator=g, device=DEVICE).to(torch.bfloat16)
    kmask = torch.where(torch.arange(L, device=DEVICE) < K1_REAL, 0.0, -1e9)
    scale = (C3 // 3 // K1_HEADS) ** -0.5

    def kernel():
        return mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale)
    got = kernel()
    ref = mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale)
    # bf16 inputs/outputs with f32 (kernel) vs bf16-rounded (plain) logits
    res = {"err": compare(torch, got, ref, "K1")}
    same_twice(torch, kernel, "K1")
    edge_err = max(compare(torch, *_k1_case(torch, mha_lanes, g, *case), f"K1 {name}")
                   for name, *case in K1_EDGES)
    name, *case = K1_OTHER_HD
    other_err = compare(torch, *_k1_case(torch, mha_lanes, g, *case), f"K1 {name}")
    mask16 = kmask.to(torch.bfloat16)[None, None, None, :]
    res.update(timed(kernel,
                     lambda: mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale),
                     lambda: sdpa_packed(torch, qkv, mask16, K1_HEADS), iters))
    res["host_us"] = host_us(kernel)
    # two L x L x hd products per (image, head); keys behind the mask count,
    # the function multiplies them too
    res.update(bound(nbytes(qkv, kmask, got),
                     {"bf16": 4 * B * K1_HEADS * L * L * (C3 // 3 // K1_HEADS)}))
    res["line"] = (f"qkv {list(K1_SHAPE)} bf16, max abs err {res['err']:.3e} "
                   f"(tol {KERNEL_TOL}), {times_txt(res)}, kernel / library "
                   f"{res['ms'] / res['library_ms']:.2f}; edges "
                   f"({', '.join(n for n, *_ in K1_EDGES)}) max abs err {edge_err:.3e}, "
                   f"{name} on the WMMA kernel {other_err:.3e}, two launches bitwise "
                   f"equal; host {res['host_us']:.1f} us per wrapper call")
    return res


@phase("k1i8")
def phase_k1i8(torch, iters):
    from oryon_tpu_torch.ops.cuda import mha_lanes
    g = torch.Generator(device=DEVICE).manual_seed(6)
    B, L, C3 = K1_SHAPE[0], K1_PADDED, K1_SHAPE[2]
    hd = C3 // 3 // K1_HEADS
    qkv = torch.randn((B, L, C3), generator=g, device=DEVICE).to(torch.bfloat16)
    kmask = torch.where(torch.arange(L, device=DEVICE) < K1_SHAPE[1], 0.0, -1e9)
    scale = hd ** -0.5

    def kernel():
        return mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale, qk_int8=True)
    got = kernel()
    ref = mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale, qk_int8=True)
    # same int8 codes and int32 sums on both sides (round half to even), so
    # what differs is K1's: bf16 exponentials and the deferred normalisation
    res = {"err": compare(torch, got, ref, "K1-i8")}
    same_twice(torch, kernel, "K1-i8")
    # the pre-pass on its own: absmax and codes are the plain version's, exactly
    absmax, codes = mha_lanes._i8_scratch(qkv, K1_HEADS)
    out = torch.empty_like(got)

    def run(phases):
        return lambda: mha_lanes.run_i8_phases(qkv, kmask, K1_HEADS, scale, phases,
                                               absmax, codes, out)
    run(mha_lanes.PREPASS)()
    torch.cuda.synchronize()
    ref_absmax, ref_codes = mha_lanes.quantise_qk_plain(qkv, K1_HEADS, scale)
    check(bool(torch.equal(absmax, ref_absmax)), "K1-i8 pre-pass: absmax differs from the plain version's")
    n_diff = int((codes != ref_codes).sum().item())
    check(n_diff == 0, f"K1-i8 pre-pass: {n_diff} of {codes.numel()} int8 codes differ from "
                       "the plain version's")
    run(mha_lanes.ATTEND)()
    torch.cuda.synchronize()
    check(bool(torch.equal(out, got)), "K1-i8: the phases run apart differ from the one call")
    edge_err = max(compare(torch, *_k1_case(torch, mha_lanes, g, *case, qk_int8=True),
                           f"K1-i8 {name}") for name, *case in K1_EDGES)
    name, *case = K1_OTHER_HD
    other_err = compare(torch, *_k1_case(torch, mha_lanes, g, *case, qk_int8=True),
                        f"K1-i8 {name}")
    # how far the int8 logits move the output from the unquantised attention
    exact = mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale)
    quant_err = (ref.float() - exact.float()).abs().max().item()
    res.update(timed(
        kernel,
        lambda: mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale, qk_int8=True),
        None, iters))   # no PyTorch call forms logits from per-head int8 codes
    res["prepass_ms"] = cuda_ms(run(mha_lanes.PREPASS), iters)
    res["attend_ms"] = cuda_ms(run(mha_lanes.ATTEND), iters)
    res["k1_same_shape_ms"] = cuda_ms(
        lambda: mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale), iters)
    mask16 = kmask.to(torch.bfloat16)[None, None, None, :]
    res["sdpa_ms"] = cuda_ms(lambda: sdpa_packed(torch, qkv, mask16, K1_HEADS), iters)
    res["host_us"] = host_us(kernel)
    res.update(bound(nbytes(qkv, kmask, got),
                     {"int8": 2 * B * K1_HEADS * L * L * hd,
                      "bf16": 2 * B * K1_HEADS * L * L * hd}))
    res["line"] = (f"qkv {[B, L, C3]} bf16, max abs err {res['err']:.3e} (tol "
                   f"{KERNEL_TOL}), int8 vs unquantised plain {quant_err:.3e}, "
                   f"{times_txt(res)}; pre-pass {res['prepass_ms']:.4f} ms (absmax and "
                   f"{codes.numel()} codes equal the plain version's), attention kernel "
                   f"{res['attend_ms']:.4f} ms, K1 (bf16 logits) at this shape "
                   f"{res['k1_same_shape_ms']:.4f} ms, unquantised SDPA {res['sdpa_ms']:.3f} ms; "
                   f"edges ({', '.join(n for n, *_ in K1_EDGES)}) max abs err {edge_err:.3e}, "
                   f"{name} on the WMMA kernel {other_err:.3e}, two launches bitwise equal; "
                   f"host {res['host_us']:.1f} us per wrapper call")
    return res


# The same edges for K5: (images, L, head dim, real tokens or None = no
# segment ids, keys 0-63 a segment of their own).
K5_EDGES = (("L=640 unpadded", 2, 640, 64, None, False), ("L=65", 2, 65, 64, None, False),
            ("L=1", 2, 1, 64, None, False), ("B=1", 1, 640, 64, 577, False),
            ("leading tile its own segment", 2, 640, 64, 577, True))
K5_OTHER_HD = ("D=32", 2, 640, 32, 577, False)


def _k5_case(torch, flash, g, B, L, D, real, lead):
    q, k, v = (torch.randn((B, K1_HEADS, L, D), generator=g, device=DEVICE).to(torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    if real is None:
        return flash.flash_mha(q, k, v, scale), flash.flash_mha_plain(q, k, v, scale)
    seg = (torch.arange(L, device=DEVICE) < real).to(torch.int32)
    if lead:
        seg[:64] = 2
    seg = seg.expand(B, L).contiguous()
    return (flash.flash_mha_padded(q, k, v, scale, seg),
            flash.flash_mha_plain(q, k, v, scale, seg))


@phase("k5")
def phase_k5(torch, iters):
    from oryon_tpu_torch.ops.cuda import flash
    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(7)
    B, H, L, real = K1_SHAPE[0], K1_HEADS, K1_PADDED, K1_SHAPE[1]
    D = K1_SHAPE[2] // 3 // H
    q, k, v = (torch.randn((B, H, L, D), generator=g, device=DEVICE).to(torch.bfloat16)
               for _ in range(3))
    seg = (torch.arange(L, device=DEVICE) < real).to(torch.int32).expand(B, L).contiguous()
    scale = D ** -0.5

    def kernel():
        return flash.flash_mha_padded(q, k, v, scale, seg)
    got = kernel()
    ref = flash.flash_mha_plain(q, k, v, scale, seg)
    res = {"err": compare(torch, got, ref, "K5 with segments")}
    same_twice(torch, kernel, "K5")
    # without segments, at the ragged unpadded length
    qr, kr, vr = (t[:, :, :real].contiguous() for t in (q, k, v))
    ragged = compare(torch, flash.flash_mha(qr, kr, vr, scale),
                     flash.flash_mha_plain(qr, kr, vr, scale), f"K5 at L={real}")
    edge_err = max(compare(torch, *_k5_case(torch, flash, g, *case), f"K5 {name}")
                   for name, *case in K5_EDGES)
    name, *case = K5_OTHER_HD
    other_err = compare(torch, *_k5_case(torch, flash, g, *case), f"K5 {name}")
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    res.update(timed(kernel,
                     lambda: flash.flash_mha_plain(q, k, v, scale, seg),
                     lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same),
                     iters))
    res["host_us"] = host_us(kernel)
    # only pairs of one segment are multiplied: real x real + padding x padding
    pairs = real * real + (L - real) * (L - real)
    res.update(bound(nbytes(q, k, v, seg, got), {"bf16": 4 * B * H * pairs * D}))
    res["line"] = (f"q, k, v {[B, H, L, D]} bf16, {real} real tokens: max abs err "
                   f"{res['err']:.3e}, unsegmented L={real} {ragged:.3e} (tol "
                   f"{KERNEL_TOL}), {times_txt(res)}, kernel / library "
                   f"{res['ms'] / res['library_ms']:.2f}; edges "
                   f"({', '.join(n for n, *_ in K5_EDGES)}) max abs err {edge_err:.3e}, "
                   f"{name} on the WMMA kernel {other_err:.3e}, two launches bitwise "
                   f"equal; host {res['host_us']:.1f} us per wrapper call")
    return res


def _swin_case(torch, g, side, C, heads, shifted: bool):
    """Window-attention inputs of one Swin-B stage: the qkv map of 16 images
    and the combined bias (relative-position bias + shift mask)."""
    from oryon_tpu_torch.models.swin import shift_attention_mask
    w = SWIN_WINDOW
    N, nw = w * w, (side // w) ** 2
    qkv_map = torch.randn((SWIN_IMAGES, side, side, 3 * C), generator=g,
                          device=DEVICE).to(torch.bfloat16)
    bias = 0.5 * torch.randn((1, heads, N, N), generator=g, device=DEVICE)
    bias = bias.expand(nw, heads, N, N)
    if shifted:
        mask = torch.from_numpy(shift_attention_mask(side, side, w, w // 2)).to(DEVICE)
        bias = bias + mask[:, None]
    return qkv_map, bias.contiguous()


def _sdpa_windows(torch, q, k, v, mask16, heads):
    """One library call for window attention on [Bw, N, C] rows."""
    Bw, N, C = q.shape
    q, k, v = (t.reshape(Bw, N, heads, C // heads).transpose(1, 2) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask16)
    return out.transpose(1, 2).reshape(Bw, N, C)


def _swin_phase(torch, iters, name, run_kernel, run_plain, prepare, run_library):
    """K3 or K4 at both stages, unshifted (numerics) and shifted (numerics
    and times).  ``prepare(qkv_map)`` gives the kernel's input tensors;
    ``run_library(*inputs, mask16, heads)`` is the PyTorch yardstick."""
    g = torch.Generator(device=DEVICE).manual_seed(8)
    w = SWIN_WINDOW
    N = w * w
    stages, err = [], 0.0
    for side, C, heads in SWIN_STAGES:
        hd = C // heads
        scale = hd ** -0.5
        for shifted in (False, True):
            qkv_map, bias = _swin_case(torch, g, side, C, heads, shifted)
            inputs = prepare(qkv_map)
            got = run_kernel(*inputs, bias, heads, scale)
            ref = run_plain(*inputs, bias, heads, scale)
            err = max(err, compare(torch, got, ref,
                                   f"{name} {side}x{side}x{C} shifted={shifted}"))
        Bw = SWIN_IMAGES * (side // w) ** 2
        mask16 = bias.to(torch.bfloat16).repeat(SWIN_IMAGES, 1, 1, 1)
        r = timed(lambda: run_kernel(*inputs, bias, heads, scale),
                  lambda: run_plain(*inputs, bias, heads, scale),
                  lambda: run_library(*inputs, mask16, heads), iters)
        # per window and head two N x N x hd products; the bias once
        r.update(bound(nbytes(*inputs, bias, got),
                       {"bf16": 4 * Bw * heads * N * N * hd}))
        stages.append(r)
        del mask16
    res = {k: sum(r[k] for r in stages) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    res.update(err=err, bound_by=stages[0]["bound_by"], stages=stages)
    res["line"] = (f"16 images, shifted windows: max abs err {err:.3e} (tol {KERNEL_TOL}); "
                   + "; ".join(f"stage {i + 1} [{side}x{side}, C={C}, {heads} heads] "
                               f"{times_txt(r)}"
                               for i, (r, (side, C, heads)) in enumerate(zip(stages, SWIN_STAGES)))
                   + "; both stages: " + times_txt(res))
    return res


@phase("k3")
def phase_k3(torch, iters):
    from oryon_tpu_torch.models.swin import window_partition
    from oryon_tpu_torch.ops.cuda import swin_attn

    def prepare(qkv_map):
        wins = window_partition(qkv_map, SWIN_WINDOW)
        return tuple(t.contiguous() for t in wins.chunk(3, dim=-1))

    def library(q, k, v, mask16, heads):
        return _sdpa_windows(torch, q, k, v, mask16, heads)
    return _swin_phase(torch, iters, "K3", swin_attn.packed_window_attention,
                       swin_attn.packed_window_attention_plain, prepare, library)


@phase("k4")
def phase_k4(torch, iters):
    from oryon_tpu_torch.models.swin import window_partition, window_reverse
    from oryon_tpu_torch.ops.cuda import swin_attn

    def kernel(qkv_map, bias, heads, scale):
        return swin_attn.band_window_attention(qkv_map, bias, heads, SWIN_WINDOW, scale)

    def plain(qkv_map, bias, heads, scale):
        return swin_attn.band_window_attention_plain(qkv_map, bias, heads, SWIN_WINDOW, scale)

    def library(qkv_map, mask16, heads):
        # partition, one attention call, reverse: together the same function
        B, side = qkv_map.shape[:2]
        q, k, v = window_partition(qkv_map, SWIN_WINDOW).chunk(3, dim=-1)
        out = _sdpa_windows(torch, q, k, v, mask16, heads)
        return window_reverse(out, SWIN_WINDOW, B, side, side)
    return _swin_phase(torch, iters, "K4", kernel, plain, lambda m: (m,), library)


def _k2_gates(torch, mk, src, tgt, bad, prec: str, what: str) -> dict:
    """masked_argmin in mode ``prec`` against the plain version: minima
    within 1e-5 (+inf where the plain version has +inf), and an argmin may
    differ only where the two plain distances (on the inputs as the mode
    rounds them) lie within 1e-6 of each other.  Two launches bitwise equal."""
    md, am = mk.masked_argmin(src, tgt, bad, prec)
    md2, am2 = mk.masked_argmin(src, tgt, bad, prec)
    pm, pa = mk.masked_argmin_plain(src, tgt, bad, prec)
    torch.cuda.synchronize()
    check(bool(torch.equal(md, md2) and torch.equal(am, am2)), f"{what}: two launches differ")
    finite = torch.isfinite(pm)
    check(bool(torch.equal(torch.isfinite(md), finite)
               and torch.equal(md[~finite], pm[~finite]) and (am[~finite] == 0).all()),
          f"{what}: rows without a kept target are not (+inf, 0)")
    err = (md[finite] - pm[finite]).abs().max().item() if bool(finite.any()) else 0.0
    check(err < 1e-5, f"{what}: minima differ by {err} >= 1e-5")
    s_r, t_r = mk._round_inputs(src, prec), mk._round_inputs(tgt, prec)
    differ = torch.nonzero(am != pa).tolist()
    for p, s in differ:
        d = 0.5 * (1.0 - t_r[p] @ s_r[p, s])
        check(not bool(bad[p, am[p, s]]), f"{what}: pair {p} row {s} chose an excluded target")
        gap = abs((d[am[p, s]] - d[pa[p, s]]).item())
        check(gap <= 1e-6, f"{what}: argmin differs at pair {p} row {s} without a near-tie "
                           f"(plain distances {gap} apart)")
    return {"err": err, "same": 1.0 - len(differ) / am.numel(), "min": md, "arg": am}


def _blob_mask(torch, P, side, keep_frac):
    """[P, side * side] bool, True = excluded: everything outside one square
    blob per pair, as serving excludes what lies outside the object mask."""
    w = int(round(side * keep_frac ** 0.5))
    bad = torch.ones((P, side, side), dtype=torch.bool, device=DEVICE)
    for p in range(P):
        y, x = (17 * p) % (side - w), (29 * p) % (side - w)
        bad[p, y:y + w, x:x + w] = False
    return bad.reshape(P, -1)


@phase("k2")
def phase_k2(torch, iters):
    from oryon_tpu_torch.ops.cuda import match_kernel as mk
    g = torch.Generator(device=DEVICE).manual_seed(2)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)
    src = unit(torch.randn(K2_PAIRS, K2_SRC, 32, generator=g, device=DEVICE))
    tgt = unit(torch.randn(K2_PAIRS, K2_TGT, 32, generator=g, device=DEVICE))
    bad = torch.rand(K2_PAIRS, K2_TGT, generator=g, device=DEVICE) < 0.4
    fp32 = _k2_gates(torch, mk, src, tgt, bad, "fp32", "K2 fp32")
    bf16 = _k2_gates(torch, mk, src, tgt, bad, "bf16", "K2 bf16")
    check(bf16["same"] >= 0.99, f"bf16 argmins agree {bf16['same']:.4f} < 0.99")
    out = {"err": fp32["err"], "fp32_same": fp32["same"], "bf16_err": bf16["err"],
           "bf16_same": bf16["same"]}

    # the pre-pass on its own, against torch.nonzero
    scratch = mk._bf16_scratch(src, tgt)
    o_min, o_arg = torch.empty_like(bf16["min"]), torch.empty_like(bf16["arg"])

    def run(phases, mask):
        return lambda: mk.run_bf16_phases(src, tgt, mask, phases, scratch, o_min, o_arg)
    run(mk.COMPACT, bad)()
    torch.cuda.synchronize()
    tgt16, idx_map, counts = scratch[:3]
    check(bool(torch.equal(counts, (~bad).sum(dim=1).to(torch.int32))),
          "K2 pre-pass: counts differ from the number of kept targets")
    for p in range(K2_PAIRS):
        kept = torch.nonzero(~bad[p]).flatten()
        check(bool(torch.equal(idx_map[p, :kept.numel()], kept.to(torch.int32))),
              f"K2 pre-pass: index map of pair {p} differs from torch.nonzero")
        check(bool(torch.equal(tgt16[p, :kept.numel()], tgt[p, kept].bfloat16())),
              f"K2 pre-pass: compacted rows of pair {p} differ")
    run(mk.REDUCE, bad)()
    torch.cuda.synchronize()
    check(bool(torch.equal(o_min, bf16["min"]) and torch.equal(o_arg, bf16["arg"])),
          "K2: the phases run apart differ from the one call")

    # edges: S and N off the tiles; pair 0 all excluded, pair 1 one target
    # kept, pair 2 none excluded, pair 3 its rows' best target three times
    S_e, N_e = 5000, 36001
    src_e = unit(torch.randn(4, S_e, 32, generator=g, device=DEVICE))
    tgt_e = unit(torch.randn(4, N_e, 32, generator=g, device=DEVICE))
    bad_e = torch.rand(4, N_e, generator=g, device=DEVICE) < 0.4
    bad_e[0] = True
    bad_e[1] = True
    bad_e[1, 20011] = False
    bad_e[2] = False
    tgt_e[3, 9000:9600] = tgt_e[3, 700:1300]
    tgt_e[3, N_e - 600:] = tgt_e[3, 700:1300]
    bad_e[3, 700:1300] = bad_e[3, 9000:9600] = bad_e[3, N_e - 600:] = False
    src_e[3, :600] = tgt_e[3, 700:1300]
    edge = _k2_gates(torch, mk, src_e, tgt_e, bad_e, "bf16", "K2 bf16 edges")
    check(bool(torch.isinf(edge["min"][0]).all() and (edge["arg"][0] == 0).all()),
          "K2: a pair with every target excluded is not (+inf, 0)")
    check(bool((edge["arg"][1] == 20011).all()), "K2: a pair with one kept target missed it")
    check(bool(torch.equal(edge["arg"][3, :600],
                           torch.arange(700, 1300, dtype=torch.int32, device=DEVICE))),
          "K2: duplicated targets did not go to the lowest index")
    _k2_gates(torch, mk, src_e, tgt_e, bad_e, "fp32", "K2 fp32 edges")

    # the serving share: everything outside a blob of 5% excluded
    blob = _blob_mask(torch, K2_PAIRS, 192, 0.05)
    sparse = _k2_gates(torch, mk, src, tgt, blob, "bf16", "K2 bf16 blob mask")

    # no single PyTorch call computes a masked cosine argmin
    out.update(timed(lambda: mk.masked_argmin(src, tgt, bad, "bf16"),
                     lambda: mk.masked_argmin_plain(src, tgt, bad, "bf16"), None, iters))
    out["compact_ms"] = cuda_ms(run(mk.COMPACT, bad), iters)
    out["reduce_ms"] = cuda_ms(run(mk.REDUCE, bad), iters)
    out["fp32_ms"] = cuda_ms(lambda: mk.masked_argmin(src, tgt, bad, "fp32"), 3)
    out["blob_ms"] = cuda_ms(lambda: mk.masked_argmin(src, tgt, blob, "bf16"), iters)
    out["blob_compact_ms"] = cuda_ms(run(mk.COMPACT, blob), iters)
    out["blob_reduce_ms"] = cuda_ms(run(mk.REDUCE, blob), iters)
    out["host_us"] = host_us(lambda: mk.masked_argmin(src, tgt, bad, "bf16"), 50)
    # one product of 32 per source and non-excluded target, on bf16-rounded
    # inputs (the mode timed), so counted at the bf16 rate
    kept = int((~bad).sum().item())
    out.update(bound(nbytes(src, tgt, bad, o_min, o_arg), {"bf16": 2 * K2_SRC * kept * 32}))
    blob_bound = bound(nbytes(src, tgt, blob, o_min, o_arg),
                       {"bf16": 2 * K2_SRC * int((~blob).sum().item()) * 32})
    out["line"] = (
        f"{K2_PAIRS} x [{K2_SRC}, 32] x [{K2_TGT}, 32], 40% excluded: fp32 min err "
        f"{out['err']:.2e}, argmins same {out['fp32_same']:.6f} (fp32) / "
        f"{out['bf16_same']:.6f} (bf16), bf16 min err {out['bf16_err']:.2e}; bf16 mode: "
        f"{times_txt(out)}; pre-pass {out['compact_ms']:.4f} ms (map, rows and counts equal "
        f"torch.nonzero's), main kernel {out['reduce_ms']:.4f} ms; fp32 mode (the CUDA-core "
        f"kernel) {out['fp32_ms']:.3f} ms; 95% excluded "
        f"(blob): {out['blob_ms']:.4f} ms (pre-pass {out['blob_compact_ms']:.4f}, main "
        f"{out['blob_reduce_ms']:.4f}, bound {blob_bound['bound_ms']:.4f} "
        f"{blob_bound['bound_by']}), argmins same {sparse['same']:.6f}; edges (S={S_e}, "
        f"N={N_e}; all, all but one, none excluded; duplicates to the lowest index) min err "
        f"{edge['err']:.2e}, argmins same {edge['same']:.6f}; two launches bitwise equal; "
        f"host {out['host_us']:.1f} us per wrapper call")
    return out


def _rigid_case(torch, rs, B=8, N=500):
    """Exact correspondences of an object-sized cloud at 0.8 m under known
    rigid transforms; the last 50 rows of each pair are invalid padding."""
    A = (rs.rand(B, N, 3) - 0.5) * 0.15 + np.array([0.0, 0.0, 0.8])
    Ts = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rs.randn(3, 3))
        Q *= np.sign(np.linalg.det(Q))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Q, rs.randn(3) * 0.1
        Ts.append(T)
    Ts = np.stack(Ts)
    Bp = np.einsum("bij,bnj->bni", Ts[:, :3, :3], A) + Ts[:, None, :3, 3]
    valid = np.ones((B, N), np.float32)
    valid[:, -50:] = 0.0
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=DEVICE)  # noqa: E731
    return f(A), f(Bp), f(valid), Ts


def _pose_err(T, T_ref):
    T = np.asarray(T, np.float64)
    d = np.linalg.norm(T[:, :3, :3] - T_ref[:, :3, :3], axis=(1, 2))
    ang = 2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1))
    return ang.max(), np.linalg.norm(T[:, :3, 3] - T_ref[:, :3, 3], axis=-1).max()


@phase("register")
def phase_register(torch):
    from oryon_tpu_torch.geometry.kabsch import masked_icp, ransac_kabsch, weighted_kabsch
    from oryon_tpu_torch.infer import full_precision_matmuls
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.pointdsc import PointDSC
    full_precision_matmuls()
    rs = np.random.RandomState(3)
    A, B, valid, Ts = _rigid_case(torch, rs)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    res = {}
    with torch.inference_mode():
        res["kabsch"] = weighted_kabsch(A, B, valid)
        res["ransac"] = ransac_kabsch(A, B, valid, torch.rand(8, 1024, 4, generator=g,
                                                              device=DEVICE))[0]
        pd = random_init_(PointDSC(), torch.Generator().manual_seed(3)).to(DEVICE).eval()
        res["pointdsc"] = pd(A, B, valid)[0]
        # ICP from a start 0.2 degree (about the cloud's centre) and 0.5 mm
        # off: outside the tolerances, inside ICP's basin on these clouds
        ang, c = np.deg2rad(0.2), np.array([0.0, 0.0, 0.8])
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1]])
        D = np.eye(4)
        D[:3, :3], D[:3, 3] = R, c - R @ c + np.array([0.0005, 0.0, 0.0])
        init = torch.tensor(Ts @ D, dtype=torch.float32, device=DEVICE)
        res["icp"] = masked_icp(A, valid, B, valid, init, iters=48, trim=0.6)
    errs = {}
    for k, T in res.items():
        r, t = _pose_err(T.cpu().numpy(), Ts)
        errs[k] = (r, t)
        check(r < ROT_TOL and t < TRANS_TOL,
              f"{k}: rotation error {r:.2e} rad, translation {t:.2e} m "
              f"(limits {ROT_TOL}, {TRANS_TOL})")
    return {"line": ", ".join(f"{k} {r:.1e} rad / {t:.1e} m" for k, (r, t) in errs.items())}


def _requests(rs, n, prompts):
    K = [600.0, 0.0, 320.0, 0.0, 600.0, 240.0, 0.0, 0.0, 1.0]

    def view():
        yy, xx = np.mgrid[0:480, 0:640]
        depth = 700.0 + 0.2 * (yy - 240) + 40.0 * rs.rand(480, 640)
        return {"rgb": (rs.rand(224, 224, 3) * 255).astype(np.uint8),
                "depth": depth.astype(np.float32), "camera": K}
    return [{"anchor": view(), "query": view(), "prompt": prompts[i % len(prompts)],
             "id": str(i)} for i in range(n)]


def _profile(torch, fn, out_dir: str) -> str:
    """One call of fn under torch.profiler: writes the kernel-time table and
    a chrome trace to out_dir; returns the device's busy share."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "serve_trace.json"))
    with open(os.path.join(out_dir, "serve_kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(spans), "the profiler saw no device activity")
    busy, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:   # union of the kernel intervals
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = spans[-1][1] - spans[0][0]
    return (f"profiled batch: {len(spans)} device ops, busy {busy / 1e3:.1f} ms of "
            f"{window / 1e3:.1f} ms ({busy / window:.1%}), tables in {out_dir}")


def _counted(torch, fn):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after: (fn's result, {kernel: launches})."""
    from oryon_tpu_torch.ops.cuda import flash, match_kernel, mha_lanes, swin_attn
    counters = {"k1": (mha_lanes, "launches"), "k1i8": (mha_lanes, "launches_i8"),
                "k2": (match_kernel, "launches"), "k3": (swin_attn, "launches_packed"),
                "k4": (swin_attn, "launches_band"), "k5": (flash, "launches")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {key: getattr(mod, attr) for key, (mod, attr) in counters.items()}


def _check_results(results, reqs):
    """Every request answered with a finite rigid pose; returns detections."""
    check(len(results) == len(reqs), f"{len(results)} results for {len(reqs)} requests")
    n_det = 0
    for r, q in zip(results, reqs):
        T = np.asarray(r["pose"], np.float64)
        check(T.shape == (4, 4) and np.isfinite(T).all(), f"pose not finite: {T}")
        det = np.linalg.det(T[:3, :3])
        check(abs(det - 1.0) < 1e-3, f"det(R) = {det}")
        check(np.allclose(T[3], [0, 0, 0, 1]), f"last row {T[3]}")
        check(isinstance(r["n_corrs"], int) and 0 <= r["n_corrs"] <= 500,
              f"n_corrs {r['n_corrs']!r}")
        check(isinstance(r["detection_valid"], bool), "detection_valid not a bool")
        check(r["prompt"] == q["prompt"], "prompt order")
        n_det += r["detection_valid"]
    return n_det


def _warm_times(torch, pred, batch8, timing_batches):
    """(seconds per warm batch, stage times as text) of pred.predict(batch8)."""
    pred.predict(batch8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timing_batches):
        pred.predict(batch8)
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / timing_batches
    events: list = []
    pred.predict(batch8, stage_events=events)
    torch.cuda.synchronize()
    stages = {n1: e0.elapsed_time(e1) for (_, e0), (n1, e1) in zip(events, events[1:])}
    return warm_s, ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items())


def _set_attn(model, clip_impl: str, swin_impl: str) -> None:
    """Switch the built towers to another attention configuration; the
    kernels add no parameters, so the weights stay as they are."""
    import dataclasses
    tower = model.vlm_visual
    tower.cfg = dataclasses.replace(tower.cfg, attn_impl=clip_impl)
    for blk in tower.resblocks:
        blk.attn.attn_impl = clip_impl
    for name, mod in model.guidance.named_modules():
        if name.endswith(".attn"):
            mod.attn_impl = swin_impl


def _min_cosine(torch, a, b) -> float:
    cos = torch.nn.functional.cosine_similarity
    return min(cos(x.float().flatten(1), y.float().flatten(1)).min().item()
               for x, y in zip(a, b))


@phase("serve")
def phase_serve(torch, timing_batches, profile_dir=None):
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import full_oryon
    from oryon_tpu_torch.models.pointdsc import PointDSC

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    model = random_init_(full_oryon(quant="int8"), gen)
    pointdsc = random_init_(PointDSC(), gen)
    pred = OryonPredictor(model, pointdsc, device=DEVICE, batch_size=8,
                          img_size=(224, 224), depth_hw=(480, 640), solver="pointdsc")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers = model.vision_cfg.layers
    rs = np.random.RandomState(4)
    reqs = _requests(rs, 12, ["mug", "laptop"])

    # the main path, counted: 12 requests = 2 batches of 8 (the second padded)
    t0 = time.perf_counter()
    results, counts = _counted(torch, lambda: pred.predict(reqs))
    cold_s = time.perf_counter() - t0
    n_batches = 2
    check(counts["k1"] == layers * n_batches,
          f"K1 ran {counts['k1']} times, expected {layers} per tower forward x {n_batches}")
    check(counts["k2"] == n_batches, f"K2 ran {counts['k2']} times, expected {n_batches}")
    n_det = _check_results(results, reqs)

    # the vision tower through K1 against the same tower on plain attention
    with torch.inference_mode():
        size = model.vision_cfg.image_size
        x = torch.rand(4, size, size, 3, generator=torch.Generator().manual_seed(5)).to(DEVICE)
        fused = model.vlm_visual(x).float()
        for blk in model.vlm_visual.resblocks:
            blk.attn.attn_impl = "einsum"
        plain = model.vlm_visual(x).float()
        for blk in model.vlm_visual.resblocks:
            blk.attn.attn_impl = "fused"
    cos = torch.nn.functional.cosine_similarity(fused.flatten(1), plain.flatten(1)).min().item()
    check(cos > 0.999, f"tower cosine fused vs einsum attention {cos:.6f} <= 0.999")

    # warm throughput at B=8 and the time of each stage (CUDA events)
    batch8 = reqs[:8]
    warm_s, stage_txt = _warm_times(torch, pred, batch8, timing_batches)
    if profile_dir:
        stage_txt += "; " + _profile(torch, lambda: pred.predict(batch8), profile_dir)
    return {"line": (f"build {build_s:.1f} s, first 12 requests {cold_s:.2f} s, "
                     f"{n_det}/12 detections, launches K1 {counts['k1']} K2 {counts['k2']}, "
                     f"tower cosine {cos:.6f}; warm B=8: {warm_s * 1e3:.1f} ms/batch = "
                     f"{8 / warm_s:.2f} pairs/s; stages: {stage_txt}"),
            "state": ({k: counts[k] for k in ("k1", "k2")}, pred, reqs)}


# (CLIP attn_impl, Swin attn_impl) -> the kernels one batch must go through:
# the first once per CLIP layer (24), the second once per Swin block (4)
OPTIN = ((("fused_i8qk", "band"), ("k1i8", "k4")),
         (("flash", "pallas"), ("k5", "k3")))
# min cosine of a tower's output against the same tower on einsum attention.
# flash, pallas and band compute the same function as einsum up to bf16
# rounding, and the default fused kernel leaves 1 - cos = 1.8e-4 on this
# int8 tower (last-bit differences flip int8 activation codes).  fused_i8qk
# adds about 1% quantisation noise to every logit by design, through 24
# residual layers, so it is allowed ten times that distance: 0.998.
COS_BOUND = {"fused_i8qk": 0.998, "flash": 0.999, "pallas": 0.999, "band": 0.999}


@phase("serve_optin")
def phase_serve_optin(torch, pred, reqs, timing_batches):
    model = pred.model
    batch8 = reqs[:8]
    gen = torch.Generator().manual_seed(5)
    size, sw = model.vision_cfg.image_size, model.swin_image_size
    x_clip = torch.rand(4, size, size, 3, generator=gen).to(DEVICE)
    x_swin = torch.randn(4, sw, sw, 3, generator=gen).to(DEVICE)
    with torch.inference_mode():
        _set_attn(model, "einsum", "einsum")
        ref_clip, ref_swin = [model.vlm_visual(x_clip)], model.guidance(x_swin)
    counts, lines = {}, []
    for (clip_impl, swin_impl), (clip_key, swin_key) in OPTIN:
        expected = {clip_key: model.vision_cfg.layers,
                    swin_key: sum(model.swin_cfg.depths), "k2": 1}
        _set_attn(model, clip_impl, swin_impl)
        results, got = _counted(torch, lambda: pred.predict(batch8))
        want = {key: expected.get(key, 0) for key in got}
        check(got == want, f"({clip_impl}, {swin_impl}): launches {got}, expected {want}")
        n_det = _check_results(results, batch8)
        counts.update({k: got[k] for k in expected if k != "k2"})
        with torch.inference_mode():
            cos_clip = _min_cosine(torch, [model.vlm_visual(x_clip)], ref_clip)
            cos_swin = _min_cosine(torch, model.guidance(x_swin), ref_swin)
        check(cos_clip > COS_BOUND[clip_impl],
              f"CLIP tower {clip_impl} vs einsum: min cosine {cos_clip:.6f} <= "
              f"{COS_BOUND[clip_impl]}")
        check(cos_swin > COS_BOUND[swin_impl],
              f"Swin tower {swin_impl} vs einsum: min cosine {cos_swin:.6f} <= "
              f"{COS_BOUND[swin_impl]}")
        warm_s, stage_txt = _warm_times(torch, pred, batch8, timing_batches)
        launches = ", ".join(f"{k} {v}" for k, v in got.items() if v)
        lines.append(f"({clip_impl}, {swin_impl}): {n_det}/8 detections, launches {launches}, "
                     f"cosine vs einsum CLIP {cos_clip:.6f} Swin {cos_swin:.6f}, warm B=8 "
                     f"{warm_s * 1e3:.1f} ms/batch = {8 / warm_s:.2f} pairs/s; "
                     f"stages: {stage_txt}")
    _set_attn(model, "fused", "einsum")   # back to the serving default
    return {"line": " | ".join(lines), "counts": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only the device, build and kernel phases")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one warm batch (torch.profiler) into DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false; this check "
              "runs on a CUDA GPU only", flush=True)
        return 1
    dev = phase_device(torch)
    phase_build()
    measured = {
        "k1": phase_k1(torch, TIMED_LAUNCHES),
        "k1i8": phase_k1i8(torch, TIMED_LAUNCHES),
        "k5": phase_k5(torch, TIMED_LAUNCHES),
        "k3": phase_k3(torch, TIMED_LAUNCHES),
        "k4": phase_k4(torch, TIMED_LAUNCHES),
        "k2": phase_k2(torch, TIMED_LAUNCHES),
    }
    if args.kernels:
        return 0
    phase_register(torch)
    counts, pred, reqs = phase_serve(torch, TIMED_BATCHES, args.profile)["state"]
    counts.update(phase_serve_optin(torch, pred, reqs, TIMED_BATCHES)["counts"])
    table = [   # key, wrapper, source, TPU kernel it replaces
        ("k1", "fused_mha_lanes_qkv", "mha_lanes.cu", "oryon_tpu/ops/pallas/mha_lanes.py:121"),
        ("k1i8", "fused_mha_lanes_qkv(qk_int8=True)", "mha_lanes.cu",
         "oryon_tpu/ops/pallas/mha_lanes.py:72"),
        ("k2", "masked_argmin", "match_kernel.cu", "oryon_tpu/ops/pallas/match_kernel.py:60"),
        ("k3", "packed_window_attention", "swin_attn.cu", "oryon_tpu/ops/pallas/swin_attn.py:90"),
        ("k4", "band_window_attention", "swin_attn.cu", "oryon_tpu/ops/pallas/swin_attn.py:204"),
        ("k5", "flash_mha_padded", "flash.cu", "oryon_tpu/ops/flash.py:84"),
    ]
    kernels = [{"name": name, "route": "cuda", "source": f"oryon_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": counts[key],
                "max_abs_err": measured[key]["err"],
                **{k: measured[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}}
               for key, name, src, replaces in table]
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
