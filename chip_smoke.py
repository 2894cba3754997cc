#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (oryon_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --kernels  # device, build and the kernel phases only
    python3 chip_smoke.py --profile DIR  # + one profiled batch, tables in DIR
    python3 chip_smoke.py --cards 4  # device, build, kernels, the CLIs over 4 cards

Phases, each printing one line with its result and its time:
  1. device    the card (torch and nvidia-smi); fails without CUDA
  2. build     nvcc builds the kernels from oryon_tpu_torch/csrc/; the
               machine code of the wgmma kernels (attention, the matcher's two
               modes, window attention) holds tensor-core (HGMMA, also for
               TF32; IGMMA for K1-i8's int8 logits) and TMA-load instructions
  3. k1        fused attention kernel (wgmma, head dim 64) vs its plain
               version at the ViT-L shape, at a tensor-parallel rank's
               [16, 577, 1536] with 8 heads and the data-parallel ranks'
               shapes, and at the edges of its tiling
               (L = 640, 65, 1, one image, a fully masked leading key tile),
               one head-dim-32 case on the WMMA kernel, two launches bitwise
               equal, the host time of one wrapper call, and the f32 mode
               at the small and tiny towers' path shapes ([4 / 16 / 64, 65,
               192], [16, 17, 192]) and the edges of its routes to 1e-5: the
               body each shape is routed to (the one-block-a-head kernel at
               L <= 128, the streaming body beyond), timed with the launch
               queue kept full and by host us a call, beside SDPA in f32 and
               the bound
  4. k1i8      the same with int8 logits (int8 wgmma behind a quantising
               pre-pass) at the padded ViT-L shape and the same edges; the
               pre-pass alone gives the plain version's absmax and int8 codes
               exactly; pre-pass and attention kernel timed apart
  5. k5        flash attention on [B, H, L, D] with segment ids, the same
               edges and a head-dim-32 case; r1: the EVA02 tower's rotary R1
               in place on q and k of the packed [16, 577, 3072] bf16 (and
               an f32 case at the tiny tower's shape) bitwise equal to its
               plain version, the class row and v untouched, two launches
               bitwise equal, timed beside the plain version, with its bound
  6. k3, k4    Swin window attention, packed windows and map-level (wgmma at
               head dim 32 behind a bias pre-pass), at both Swin-B stages,
               shifted and unshifted, and at the edges of the tiling (one
               window, fewer items than persistent blocks, more than one
               round, 16- and 64-token windows, head dims 16 and 64 on the
               WMMA kernel); the pre-pass alone gives its plain version's
               fragments exactly; pre-pass and attention kernel timed apart
  7. k2        masked-argmin kernels vs their plain version at the serving
               shape and at a data-parallel rank's 4 pairs, in both modes:
               bf16 (compacting pre-pass + bf16 wgmma) and fp32 (compacting
               and splitting pre-pass + split-TF32 wgmma), 40% and 95% of the
               targets excluded, ragged sizes, pairs with all / all but one /
               no target excluded, duplicated targets; each pre-pass against
               torch.nonzero and its plain version (bf16 rows;
               split_tf32_plain's hi / lo rows, bitwise); pre-pass and main
               kernel timed apart; the fp32 mode timed with its bound
               (3 x TF32)
  8. register  Kabsch, RANSAC, PointDSC and ICP recover a known rigid
               transform in full f32 (catches TF32 in the pose math); the
               poses are scored on the card with the port's rotation /
               translation errors, ADD and ADD-S
  9. serve     full_oryon(quant="int8") + PointDSC + ICP behind
               OryonPredictor at B=8 answers 12 requests; launch counters
               show the main path went through K1 and K2; one counted batch
               of 8 each with ICP off and with RANSAC (K1 24, K2 1)
 10. serve_optin  the same predictor switched to (fused_i8qk, Swin band) and
               to (flash, Swin pallas): one counted batch of 8 each, through
               K1-i8 + K4 and K5 + K3; serve_fp32: a strict-parity run, the
               served model's pipeline with MatchParams(precision="fp32") on
               a batch of 8 beside the default on the same draws (K1 24, K2
               fp32 1, masks equal); then the small model (f32 towers)
               answers 2 requests through K1's f32 mode (the
               one-block-a-head kernel, by the profiler) and K2;
               serve_eva: full_oryon(vlm="eva02") in bf16 + PointDSC + ICP
               at B=8 answers 8 requests: R1 and K1 24 launches each, K2 1,
               no rotation on the plain path (counter rope_plain); its
               tower through K1 + R1 against the same tower on the plain
               rotary and einsum attention; warm pairs/s; the SwiGLU's
               products at the served rows with hidden 2730 beside the
               aligned 2736 and 2752
 11. ckpt      the served model is saved with the port's save_checkpoint into
               a temporary experiment; OryonPredictor.from_config (another
               init seed, eval.ckpt=last, PointDSC from a fake published
               snapshot) serves 8 requests as a predictor built directly on
               the saved weights does: masks and correspondence counts
               equal, poses within the registration bounds, K1 24 and K2 1
               launches; a missing epoch raises, an empty experiment warns
               and answers; PointDSC from the snapshot and from native.npz
               registers like the module they were made from
 12. cli       run_infer_torch.main answers a two-line JSONL of png views
               from that checkpoint, in-process on the card
 13. eval      a REAL275-format tree (2 box objects, 16 pairs at 480 x 640,
               depth rendered from the ground-truth poses) evaluated by
               run_test_torch.main at full width: 16 CSV lines, the
               metrics JSON, K1 48 and K2 2 launches; the ground-truth pose
               scores recall 1 (ADD(S), MSSD, MSPD, VSD), a pose 5 cm off
               scores as on the CPU; sweeps of the split 8 times over with
               and without scoring, between two from batches collated
               beforehand, each batch's time split into loader wait,
               dispatch and the rest; the window render and the scoring of
               a batch timed;
               debug_valid (ground-truth correspondences, no K2) and
               nn_correspondences_anchors (one K2 launch) on one batch
 14. native    the port's C++ host library (oryon_tpu_torch/native/) built
               into an empty directory; at 480 x 640 -> 224 x 224 its RLE and
               nearest resize equal their plain versions and its bilinear
               resize is within 1 LSB of its plain version (differing bytes
               counted); host ms a call of each; the trainer's loader alone
               over the train tree (B=32, uint8 RGB cache), with the library
               and with the plain versions in turns, each batch's host time
               split into reading, augmenting and collating
 15. train     run_train_torch.main at full width (bf16 towers, K1 fused,
               B=32, device augmentation, the prompt cache) over a 64-pair
               ShapeNet6D-format tree it writes (480 x 640, synthetic_pair):
               2 epochs of 2 steps with validation on the eval phase's tree
               (K1 24 a step and a validation batch, K2 1 a validation
               batch), then a resume for a third epoch that continues step,
               optimizer state and LR; steps from the loader split into
               loader wait, augment, forward + loss, backward and optimizer;
               pairs/s trained; peak memory
 16. pointdsc_train  oryon_tpu_torch.scripts.train_pointdsc at its defaults
               (6 layers, n=256, B=8, lr 1e-4) for 300 steps: the BCE falls,
               the inlier accuracy ends above 0.6, the median step is timed;
               the written native.npz loads through build_pointdsc_solver,
               registers a known rigid pair on the card as on the CPU, and
               serves one batch of 8 at full width (K1 24, K2 1)
 17. tools     the offline tools over the eval and train phases' trees:
               make_pair_split (16 pairs) on the card against the CPU;
               compute_metrics on the eval phase's CSV against its metrics;
               null_baselines (the ground truth scores recall 1);
               sweep_checkpoints over the train phase's 3 epochs with the
               trained PointDSC (K1 48, K2 2 an epoch; its last row equals
               run_test_torch on that checkpoint); sweep_eval_hparams with
               two variants; each fusion ablation at full width in bf16
               against its f32 CPU run (cosine > 0.999)
 18. overfit   10 AdamW steps at full width on one synthetic batch of 8 with
               the same draws each step: the loss falls
 19. train_towers  2 steps at full width, B=32, with the vision and Swin
               towers trained: K1 24 + 24 (recomputed) and K1's backward
               kernel 24 a step, gradients in both towers and none in the
               text tower, peak memory; the step's fusion/decoder gradient
               against the einsum tower's (cosine > 0.999, loss within 1e-2);
               attn_impl=flash raises in backward; K1's backward kernel
               (wgmma + TMA at head dim 64) against its plain version
               (autograd through reference_mha) at [64, 577, 3072] (d qkv
               and d kmask, two launches bitwise equal; timed beside the
               plain version and SDPA's backward, with its bound and peak
               memory; its query-tile and key-tile kernels timed alone), at
               [16, 640, 3072] with keys >= 577 masked and qk_int8 off and on;
               the mma.sync body the route gives at head dim 32 (d qkv and d
               kmask, one launch counted, two launches bitwise equal)
 20. train_towers_small  steps of the small model (f32 towers) at B=32 with
               its towers trained: K1 4 and K1's backward 2 a step, each one
               CUDA kernel by the profiler (the one-block-a-head kernels,
               none of the former bodies'), the loss finite, the tower and
               fusion/decoder gradients vs the einsum tower's (cosine >
               0.999), the step's device ms; K1's f32 backward at the path
               shapes and edges against its plain version (d qkv and d
               kmask, two launches bitwise equal, kernels a call: a captured
               CUDA graph's kernel nodes), the routed body timed (queue
               full, host us, through autograd) beside SDPA's f32 backward
 21. mesh1     one NCCL rank in this process: serving_mesh gives no mesh; the
               train step over make_mesh(-1, 1) (gradient all-reduce, global
               loss normaliser, global draws) equals the plain step bitwise
               at full width, B=32; both timed in turns
 22. dp2       two gloo ranks spawned on the one card (NCCL refuses two ranks
               on one GPU), mesh.data=2: 3 steps with run_train.py's defaults
               at B=32 (16 a rank) against one device on the same batches and
               draws (losses within rel 1e-3, fusion/decoder gradient cosine
               above 0.9999); a served batch of 8 (4 a rank) bitwise one
               device's runs of each rank's pairs with the same draws; K1 and
               K2 launches per rank
 23. tp2       the same two ranks, mesh.model=2, int8: the sharded vision
               tower and featmaps against the unsharded model's (cosine above
               0.999), served masks; K1 at 8 heads a rank
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
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

K1_SHAPE = (16, 577, 3 * 1024)    # 2B images x (CLS + 24^2 tokens) x 3C, ViT-L
K1_TRAIN_SHAPE = (64, 577, 3 * 1024)   # the trainer's 2B images at B=32, no pad mask
K1_HEADS, K1_REAL = 16, 560       # keys >= K1_REAL carry the -1e9 pad mask
K1_PADDED = 640                   # the tower pads 577 -> 640 for fused_i8qk and flash
# a rank of mesh.model=2 serving B=8: its 8 of 16 heads; the two ranks of
# mesh.data=2 training at B=32 and serving at B=8
K1_TP_SHAPE = (16, 577, 3 * 512)
K1_DP_SHAPES = ((32, 577, 3 * 1024), (8, 577, 3 * 1024))
K2_PAIRS, K2_SRC, K2_TGT = 8, 5120, 192 * 192
# Swin-B on 16 images at 384^2: (padded map side, channels, heads) per stage
SWIN_STAGES = ((98, 128, 4), (49, 256, 8))
SWIN_IMAGES, SWIN_WINDOW = 16, 7
KERNEL_TOL = 2e-2                 # bf16 outputs: about one ulp at |x| in [2, 4)
# published dense peaks of one H100 SXM: bytes/s of HBM3, operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
ROT_TOL, TRANS_TOL = 1e-3, 1e-4   # registration: rad, m
ADD_TOL = 1e-4                    # ADD and ADD-S of a recovered pose, m
TIMED_LAUNCHES = 20               # per kernel timing run
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


def in_turns(fns: dict, iters: int) -> dict:
    """Mean device ms of each function, each the mean of two runs: all in
    order, then all in reverse order."""
    first = {k: cuda_ms(f, iters) for k, f in fns.items()}
    second = {k: cuda_ms(fns[k], iters) for k in reversed(list(fns))}
    return {k: (first[k] + second[k]) / 2 for k in fns}


def alternate(kernel, plain, iters: int):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    t = in_turns({"plain": plain, "kernel": kernel}, iters)
    return t["kernel"], t["plain"]


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


def queued_ms(fn, iters: int) -> float:
    """Mean device time of fn() with the launch queue kept full: a sleeping
    kernel of about 2 ms goes first, the host enqueues every call behind it,
    and the events then bracket back-to-back device work.  For kernels whose
    device time is near the host time of their wrapper call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    modes, the matcher's two and the window attention's two) and per
    one-block-a-head f32 kernel of K1 (each head dim), how many instructions
    of each of SASS_OPS its machine code holds; None where the toolkit has
    no cuobjdump."""
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
        if any(k in name for k in ("attn_wgmma_kernel", "match_wgmma_kernel",
                                   "match_tf32_kernel", "swin_wgmma_kernel",
                                   *K1_F32_HEAD_KERNELS)):
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
        # P V); match_wgmma_kernel: K2 bf16; match_tf32_kernel: K2 fp32 (TF32
        # products, HGMMA too); swin_wgmma_kernel<band, ...>: false K3, true
        # K4.  All load their tiles by TMA; so do K1's f32 kernels and its f32
        # backward at the small towers' shapes, which multiply on the CUDA
        # cores (one kernel a head dim).
        want = {"K1": ("attn_wgmma_kernelILi0E", ("HGMMA",)),
                "K5": ("attn_wgmma_kernelILi1E", ("HGMMA",)),
                "K1-i8": ("attn_wgmma_kernelILi2E", ("HGMMA", "IGMMA")),
                "K2": ("match_wgmma_kernel", ("HGMMA",)),
                "K2 fp32": ("match_tf32_kernel", ("HGMMA",)),
                "K3": ("swin_wgmma_kernelILb0E", ("HGMMA",)),
                "K4": ("swin_wgmma_kernelILb1E", ("HGMMA",))}
        want.update({f"K1 f32 hd {hd}": (f"mha_f32_head_kernelILi{hd}E", ()) for hd in (16, 32)})
        want.update({f"K1 bwd f32 hd {hd}": (f"mha_bwd_f32_head_kernelILi{hd}E", ())
                     for hd in (16, 32)})
        check(len(sass) == len(want), f"TMA kernels in the library: {sorted(sass)}")
        found = {}
        for label, (key, ops) in want.items():
            hits = [c for name, c in sass.items() if key in name]
            check(len(hits) == 1, f"{label}: {len(hits)} kernels named {key} in the library")
            got = dict(zip(SASS_OPS, hits[0]))
            check(all(got[op] > 0 for op in ops + ("UTMALDG",))
                  and (got["IGMMA"] == 0 or "IGMMA" in ops),
                  f"{label}: SASS instruction counts {got}, expected {ops} and UTMALDG")
            found[label] = hits[0]
        line += f"; TMA kernels' SASS ({'/'.join(SASS_OPS)}): " + ", ".join(
            f"{label} {'/'.join(map(str, c))}" for label, c in found.items())
    return {"line": line}


# Edges of the wgmma kernel's tiling (64 query rows a warpgroup, key tiles of
# 64), at the tower's width: (images, L, head dim, first padded key, keys 0-63
# masked too).  The head-dim-32 case runs the WMMA kernel.
K1_EDGES = (("L=640 unpadded", 2, 640, 64, 640, False), ("L=65", 2, 65, 64, 65, False),
            ("L=1", 2, 1, 64, 1, False), ("B=1", 1, 577, 64, 560, False),
            ("masked leading tile", 2, 640, 64, 577, True))
K1_OTHER_HD = ("hd=32", 2, 577, 32, 560, False)
# K1's f32 mode on the small and tiny towers (ViT at 112^2 and 56^2, patch 14:
# 1 + 8^2 and 1 + 4^2 tokens, width 64, 4 heads of 16), [B, L, 3C] as their
# paths run it: serve_small (2 pairs), a served batch of 8, a train_towers
# step at B=32, a tiny batch of 8.  The one-block-a-head kernels serve them;
# the bodies they replaced (the streaming forward, the two-kernel backward,
# K1_F32_OLD_KERNELS) serve longer L.  K1_F32_EDGES: L of one key, of the
# longest a block holds, one more (the streaming body) and head dim 32.
K1_F32_PATHS = ((4, 65, 192), (16, 65, 192), (64, 65, 192), (16, 17, 192))
K1_F32_EDGES = ((2, 1, 192), (2, 128, 192), (2, 129, 192), (2, 128, 384))
K1_F32_HEADS, K1_F32_TOL = 4, 1e-5
K1_F32_HEAD_KERNELS = ("mha_f32_head_kernel", "mha_bwd_f32_head_kernel")
K1_F32_OLD_KERNELS = ("mha_lanes_f32_kernel", "dq_f32_kernel", "dkv_f32_kernel",
                      "colsum_kernel")


def _k1_case(torch, mha_lanes, g, B, L, hd, real, lead, qk_int8=False):
    qkv = torch.randn((B, L, 3 * K1_HEADS * hd), generator=g, device=DEVICE).to(torch.bfloat16)
    kmask = torch.where(torch.arange(L, device=DEVICE) < real, 0.0, -1e9)
    if lead:
        kmask[:64] = -1e9
    scale = hd ** -0.5
    return (mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale, qk_int8),
            mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale, qk_int8))


def _f32_times_txt(times: dict) -> str:
    """Per path shape: the routed body's device ms with the queue full and
    host us a call (and, for the backward, ms through autograd and kernels a
    call without and with d kmask), the plain version, SDPA, the bound."""
    parts = []
    for shape, r in times.items():
        body = (f"{r['ms']:.4f} ms / {r['host_us']:.1f} us"
                + (f" / autograd {r['grad_ms']:.4f} ms / kernels {r['kernels']}"
                   if "grad_ms" in r else ""))
        parts.append(f"{shape}: {body}; plain {r['plain_ms']:.3f} ms, SDPA "
                     f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return " | ".join(parts)


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
    f32_err, f32 = _k1_f32(torch, mha_lanes, g, iters)
    # the kernels line: the small model's train_towers step's shape
    step = f32[str(list(K1_F32_PATHS[2]))]
    res["f32"] = dict(step, err=f32_err)
    res["train"] = _k1_train(torch, mha_lanes, g, iters)
    res["tp"] = _k1_train(torch, mha_lanes, g, iters, K1_TP_SHAPE, K1_HEADS // 2,
                          "a tensor-parallel rank's shape")
    dp_err = _k1_rank_shapes(torch, mha_lanes, g)
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
                   f"equal; host {res['host_us']:.1f} us per wrapper call; f32 mode at "
                   + ", ".join(str(list(s_)) for s_ in K1_F32_PATHS + K1_F32_EDGES)
                   + f": max abs err {f32_err:.2e} (tol {K1_F32_TOL}); "
                   + _f32_times_txt(f32) + "; training "
                   f"shape {list(K1_TRAIN_SHAPE)}, no pad mask: max abs err "
                   f"{res['train']['err']:.3e}, {times_txt(res['train'])}; tensor-parallel "
                   f"rank {list(K1_TP_SHAPE)} with {K1_HEADS // 2} heads: max abs err "
                   f"{res['tp']['err']:.3e}, {times_txt(res['tp'])}; data-parallel ranks "
                   + ", ".join(str(list(s_)) for s_ in K1_DP_SHAPES)
                   + f": max abs err {dp_err:.3e}")
    return res


def _k1_train(torch, mha_lanes, g, iters, shape=K1_TRAIN_SHAPE, heads=K1_HEADS,
              what="the training shape"):
    """K1 at ``shape`` with ``heads`` heads and no key masked (the trainer's
    shape by default; the tensor-parallel rank's local heads) against
    reference_mha at KERNEL_TOL; timed beside the plain version and SDPA,
    with its bound."""
    B, L, C3 = shape
    qkv = torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
    kmask = torch.zeros(L, device=DEVICE)
    scale = (C3 // 3 // heads) ** -0.5

    def kernel():
        return mha_lanes.fused_mha_lanes_qkv(qkv, kmask, heads, scale)

    def plain():
        return mha_lanes.reference_mha(qkv, kmask, heads, scale)
    got = kernel()
    res = {"err": compare(torch, got, plain(), f"K1 at {what}")}
    res.update(timed(kernel, plain, lambda: sdpa_packed(torch, qkv, None, heads), iters))
    res.update(bound(nbytes(qkv, kmask, got),
                     {"bf16": 4 * B * heads * L * L * (C3 // 3 // heads)}))
    return res


def _k1_rank_shapes(torch, mha_lanes, g):
    """K1 against reference_mha at the data-parallel ranks' shapes (no key
    masked): max abs error."""
    err = 0.0
    for shape in K1_DP_SHAPES:
        qkv = torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        kmask = torch.zeros(shape[1], device=DEVICE)
        scale = (shape[2] // 3 // K1_HEADS) ** -0.5
        err = max(err, compare(torch, mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale),
                               mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale),
                               f"K1 at {list(shape)}"))
    return err


def device_kernels(torch, fn, enough=bool, attempts: int = 3) -> dict:
    """{name: launches} of the CUDA kernels fn() ran, by torch.profiler
    (copies and fills left out), the window opening and closing 5 ms of host
    time away from fn's work.  On the card the profiler now and then drops
    launches (a window of 20 calls once showed 4) and never adds one: the
    window is run again, up to ``attempts`` times, until ``enough`` holds of
    the counts, each name's largest count kept."""
    from torch.profiler import ProfilerActivity, profile
    best: dict = {}
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
        names = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))):
                names[e.name] = names.get(e.name, 0) + 1
        for name, n in names.items():
            best[name] = max(best.get(name, 0), n)
        if enough(best):
            break
    return best


def graph_kernels(torch, fn) -> int:
    """The CUDA kernels one fn() call launches: the kernel nodes of a CUDA
    graph captured from the call, counted through cuGraphGetNodes: exact
    where torch.profiler may drop a launch.  fn runs once first on a
    side stream, outside the capture, as torch.cuda.graph asks."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return kinds.count(0)   # CU_GRAPH_NODE_TYPE_KERNEL


def kernels_named(names: dict, keys) -> int:
    return sum(n for name, n in names.items() if any(k in name for k in keys))


def _f32_inputs(torch, g, shape, grad=False):
    """qkv [B, L, 3C] f32 (requiring a gradient if asked), kmask [L] (the
    unpadded towers mask no key) and dout [B, L, C] from a generator."""
    qkv = torch.randn(shape, generator=g, device=DEVICE).requires_grad_(grad)
    return (qkv, torch.zeros(shape[1], device=DEVICE),
            torch.randn((*shape[:2], shape[2] // 3), generator=g, device=DEVICE))


def _k1_f32(torch, mha_lanes, g, iters):
    """K1's f32 mode at the towers' path shapes and at K1_F32_EDGES: the body
    the route gives against reference_mha within K1_F32_TOL (4 heads, 32
    keys masked at -1e9 where L > 64), one launch counted a call, two
    launches bitwise equal.  Per path shape: the device ms with the launch
    queue kept full and the host us of a wrapper call; SDPA in f32 with the
    queue full; the plain version; the bound.  Returns (max error, {shape:
    timings})."""
    err = 0.0
    for shape in K1_F32_PATHS + K1_F32_EDGES:
        qkv, kmask, _ = _f32_inputs(torch, g, shape)
        if shape[1] > 64:
            kmask[-32:] = -1e9
        scale = (shape[2] // 3 // K1_F32_HEADS) ** -0.5

        def kernel():
            return mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_F32_HEADS, scale)
        ref = mha_lanes.reference_mha(qkv, kmask, K1_F32_HEADS, scale)
        before = mha_lanes.launches
        got = kernel()
        check(mha_lanes.launches == before + 1 and got.dtype == torch.float32,
              f"K1 f32 {list(shape)}: no launch counted or dtype {got.dtype}")
        same_twice(torch, kernel, f"K1 f32 {list(shape)}")
        e = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()) and e < K1_F32_TOL,
              f"K1 f32 {list(shape)}: max |kernel - plain| = {e} >= {K1_F32_TOL}")
        err = max(err, e)
    res = {}
    for shape in K1_F32_PATHS:
        B, L, C3 = shape
        qkv, kmask, _ = _f32_inputs(torch, g, shape)
        scale = (C3 // 3 // K1_F32_HEADS) ** -0.5

        def kernel():
            return mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_F32_HEADS, scale)
        r = {"ms": queued_ms(kernel, iters), "host_us": host_us(kernel),
             "plain_ms": cuda_ms(lambda: mha_lanes.reference_mha(qkv, kmask, K1_F32_HEADS,
                                                                 scale), iters),
             "library_ms": queued_ms(lambda: sdpa_packed(
                 torch, qkv, kmask[None, None, None, :], K1_F32_HEADS), iters)}
        # qkv and kmask read, the [B, L, C] output written; two L x L x hd
        # products a head
        r.update(bound(nbytes(qkv, kmask) + qkv.numel() // 3 * 4,
                       {"f32": 4 * B * L * L * (C3 // 3)}))
        res[str(list(shape))] = r
    return err, res


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


def _r1_case(torch, rope, g, shape, heads, dtype, pt_grid):
    """(qkv, R1's output, the plain version's output, cos, sin) of one case."""
    from oryon_tpu_torch.models.clip import rope_tables
    B, L, C3 = shape
    grid = int(round((L - 1) ** 0.5))
    qkv = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    cos, sin = (torch.from_numpy(t).to(DEVICE)
                for t in rope_tables(C3 // 3 // heads, grid, pt_grid))
    got = rope.rope_qk_(qkv.clone(), cos, sin, heads)
    want = rope.rope_qk_plain_(qkv.clone(), cos, sin, heads)
    torch.cuda.synchronize()
    C = C3 // 3
    check(torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[..., 2 * C:], qkv[..., 2 * C:]),
          f"R1 at {list(shape)} {dtype}: the class row or v changed")
    differ = int((got != want).sum())
    check(differ == 0, f"R1 at {list(shape)} {dtype}: {differ} elements differ from the "
                       f"plain version")
    return qkv, got, want, cos, sin


@phase("r1")
def phase_r1(torch, iters):
    from oryon_tpu_torch.models.clip import EVA_PT_GRID
    from oryon_tpu_torch.ops.cuda import rope
    g = torch.Generator(device=DEVICE).manual_seed(22)
    B, L, C3 = K1_SHAPE
    C, H = C3 // 3, K1_HEADS
    qkv, got, want, cos, sin = _r1_case(torch, rope, g, K1_SHAPE, H, torch.bfloat16,
                                        EVA_PT_GRID)
    # the tiny tower's shape in f32 (4 heads of 16)
    _r1_case(torch, rope, g, (2, 17, 3 * 64), 4, torch.float32, EVA_PT_GRID)
    buf = qkv.clone()
    same_twice(torch, lambda: rope.rope_qk_(buf.copy_(qkv), cos, sin, H).clone(), "R1")
    res = {"err": compare(torch, got, want, "R1")}
    res.update(timed(lambda: rope.rope_qk_(buf, cos, sin, H),
                     lambda: rope.rope_qk_plain_(buf, cos, sin, H), None, iters))
    res["host_us"] = host_us(lambda: rope.rope_qk_(buf, cos, sin, H))
    # q and k of the patch rows read and written once, the f32 tables read
    # once; two products and a sum an element, in f32
    elems = B * (L - 1) * 2 * C
    res.update(bound(2 * elems * qkv.element_size() + nbytes(cos, sin), {"f32": 3 * elems}))
    res["line"] = (f"qkv {[B, L, C3]} bf16, {H} heads: bitwise the plain version (and f32 at "
                   f"[2, 17, 192]), class row and v untouched, two launches bitwise equal; "
                   f"{times_txt(res)}, bound / kernel {res['bound_ms'] / res['ms']:.1%}; "
                   f"host {res['host_us']:.1f} us per wrapper call")
    return res


def _swin_case(torch, g, side, C, heads, shifted: bool, images=None, w=None):
    """Window-attention inputs: the qkv map of ``images`` images (16, one
    Swin-B stage, unless given) and the combined bias (relative-position bias
    + shift mask)."""
    from oryon_tpu_torch.models.swin import shift_attention_mask
    w = SWIN_WINDOW if w is None else w
    N, nw = w * w, (side // w) ** 2
    qkv_map = torch.randn((SWIN_IMAGES if images is None else images, side, side, 3 * C),
                          generator=g, device=DEVICE).to(torch.bfloat16)
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


# Edges of the wgmma window kernel's tiling (one warpgroup a (window, head),
# persistent blocks): (images, map side, C, heads, window, shifted).  The
# head-dim-16 and -64 cases run the WMMA kernel.
SWIN_EDGES = (("one window", 1, 7, 32, 1, 7, False),
              ("fewer items than blocks", 2, 14, 128, 4, 7, True),
              ("1215 items, 3 heads", 5, 63, 96, 3, 7, True),
              ("w=4", 2, 8, 64, 2, 4, True),
              ("w=8", 2, 16, 256, 8, 8, False))
SWIN_OTHER_HD = (("hd=16", 3, 21, 32, 2, 7, True), ("hd=64", 1, 7, 128, 2, 7, False))


def _swin_phase(torch, iters, name, run_kernel, run_plain, prepare, run_library, phases,
                frag_dtype):
    """K3 or K4 at both stages, unshifted (numerics) and shifted (numerics
    and times), and at the edges.  ``prepare(qkv_map, w)`` gives the kernel's
    input tensors; the kernel and the plain version take (*inputs, bias,
    heads, w, scale); ``run_library(*inputs, mask16, heads)`` is the PyTorch
    yardstick; ``phases(*inputs, bias, heads, scale, which, frag, out)`` runs
    the bias pre-pass or the attention kernel alone."""
    from oryon_tpu_torch.ops.cuda import swin_attn
    g = torch.Generator(device=DEVICE).manual_seed(8)
    w = SWIN_WINDOW
    N = w * w
    stages, err = [], 0.0
    for side, C, heads in SWIN_STAGES:
        hd = C // heads
        scale = hd ** -0.5
        for shifted in (False, True):
            qkv_map, bias = _swin_case(torch, g, side, C, heads, shifted)
            inputs = prepare(qkv_map, w)
            got = run_kernel(*inputs, bias, heads, w, scale)
            ref = run_plain(*inputs, bias, heads, w, scale)
            err = max(err, compare(torch, got, ref,
                                   f"{name} {side}x{side}x{C} shifted={shifted}"))

        def kernel():
            return run_kernel(*inputs, bias, heads, w, scale)
        same_twice(torch, kernel, f"{name} {side}x{side}x{C}")
        # the pre-pass on its own: the plain version's fragments, exactly
        frag = swin_attn._frag_scratch(bias, frag_dtype)
        out = torch.empty_like(got)

        def run(which):
            return lambda: phases(*inputs, bias, heads, scale, which, frag, out)
        run(swin_attn.BIAS)()
        torch.cuda.synchronize()
        check(bool(torch.equal(frag, swin_attn.bias_fragments_plain(bias, frag_dtype))),
              f"{name} pre-pass: the bias fragments differ from the plain version's")
        run(swin_attn.ATTEND)()
        torch.cuda.synchronize()
        check(bool(torch.equal(out, got)), f"{name}: the phases run apart differ from the one call")
        Bw = SWIN_IMAGES * (side // w) ** 2
        mask16 = bias.to(torch.bfloat16).repeat(SWIN_IMAGES, 1, 1, 1)
        r = timed(kernel, lambda: run_plain(*inputs, bias, heads, w, scale),
                  lambda: run_library(*inputs, mask16, heads), iters)
        # the device time of a call is near the host time of the wrapper: the
        # kernel's time is the one taken with the launch queue kept full
        r["loop_ms"], r["ms"] = r["ms"], queued_ms(kernel, iters)
        r["prepass_ms"] = queued_ms(run(swin_attn.BIAS), iters)
        r["attend_ms"] = queued_ms(run(swin_attn.ATTEND), iters)
        r["host_us"] = host_us(kernel)
        # per window and head two N x N x hd products; the bias once
        r.update(bound(nbytes(*inputs, bias, got),
                       {"bf16": 4 * Bw * heads * N * N * hd}))
        stages.append(r)
        del mask16

    def case(images, side, C, heads, w, shifted):
        qkv_map, bias = _swin_case(torch, g, side, C, heads, shifted, images, w)
        inputs = prepare(qkv_map, w)
        scale = (C // heads) ** -0.5
        return (run_kernel(*inputs, bias, heads, w, scale),
                run_plain(*inputs, bias, heads, w, scale))
    edge_err = max(compare(torch, *case(*c), f"{name} {label}") for label, *c in SWIN_EDGES)
    other_err = max(compare(torch, *case(*c), f"{name} {label}") for label, *c in SWIN_OTHER_HD)
    res = {k: sum(r[k] for r in stages) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    res.update(err=err, bound_by=stages[0]["bound_by"], stages=stages)
    res["line"] = (f"16 images, shifted windows: max abs err {err:.3e} (tol {KERNEL_TOL}); "
                   + "; ".join(f"stage {i + 1} [{side}x{side}, C={C}, {heads} heads] "
                               f"{times_txt(r)}; kernel = {r['ms']:.4f} ms with the launch "
                               f"queue kept full = pre-pass {r['prepass_ms']:.4f} (fragments "
                               f"equal the plain version's) + attention kernel "
                               f"{r['attend_ms']:.4f}; {r['loop_ms']:.4f} ms a call at the "
                               f"host's pace, host {r['host_us']:.1f} us per wrapper call"
                               for i, (r, (side, C, heads)) in enumerate(zip(stages, SWIN_STAGES)))
                   + "; both stages: " + times_txt(res)
                   + f"; edges ({', '.join(n for n, *_ in SWIN_EDGES)}) max abs err "
                     f"{edge_err:.3e}, {' and '.join(n for n, *_ in SWIN_OTHER_HD)} on the WMMA "
                     f"kernel {other_err:.3e}, two launches bitwise equal")
    return res


@phase("k3")
def phase_k3(torch, iters):
    from oryon_tpu_torch.models.swin import window_partition
    from oryon_tpu_torch.ops.cuda import swin_attn

    def prepare(qkv_map, w):
        wins = window_partition(qkv_map, w)
        return tuple(t.contiguous() for t in wins.chunk(3, dim=-1))

    def kernel(q, k, v, bias, heads, w, scale):
        return swin_attn.packed_window_attention(q, k, v, bias, heads, scale)

    def plain(q, k, v, bias, heads, w, scale):
        return swin_attn.packed_window_attention_plain(q, k, v, bias, heads, scale)

    def library(q, k, v, mask16, heads):
        return _sdpa_windows(torch, q, k, v, mask16, heads)
    return _swin_phase(torch, iters, "K3", kernel, plain, prepare, library,
                       swin_attn.run_packed_phases, torch.bfloat16)


@phase("k4")
def phase_k4(torch, iters):
    from oryon_tpu_torch.models.swin import window_partition, window_reverse
    from oryon_tpu_torch.ops.cuda import swin_attn

    def library(qkv_map, mask16, heads):
        # partition, one attention call, reverse: together the same function
        B, side = qkv_map.shape[:2]
        q, k, v = window_partition(qkv_map, SWIN_WINDOW).chunk(3, dim=-1)
        out = _sdpa_windows(torch, q, k, v, mask16, heads)
        return window_reverse(out, SWIN_WINDOW, B, side, side)

    def phases(qkv_map, bias, heads, scale, which, frag, out):
        swin_attn.run_band_phases(qkv_map, bias, heads, SWIN_WINDOW, scale, which, frag, out)
    return _swin_phase(torch, iters, "K4", swin_attn.band_window_attention,
                       swin_attn.band_window_attention_plain, lambda m, w: (m,), library,
                       phases, torch.float32)


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


def _k2_prepass(torch, mk, src, tgt, bad, prec: str, reference) -> None:
    """A mode's pre-pass alone against torch.nonzero: counts and index map
    exactly, the kept rows bitwise ``reference(rows of pair p)``'s; then its
    main kernel alone gives the one call's result."""
    scratch = mk._scratch(src, tgt, prec)
    o_min, o_arg = (torch.empty(src.shape[:2], dtype=dt, device=DEVICE)
                    for dt in (torch.float32, torch.int32))
    mk.run_phases(src, tgt, bad, mk.COMPACT, scratch, o_min, o_arg, prec)
    torch.cuda.synchronize()
    rows, idx_map, counts = scratch[:3]
    check(bool(torch.equal(counts, (~bad).sum(dim=1).to(torch.int32))),
          f"K2 {prec} pre-pass: counts differ from the number of kept targets")
    for p in range(src.shape[0]):
        kept = torch.nonzero(~bad[p]).flatten()
        n = kept.numel()
        check(bool(torch.equal(idx_map[p, :n], kept.to(torch.int32))),
              f"K2 {prec} pre-pass: index map of pair {p} differs from torch.nonzero")
        got = rows[p, :n] if prec == "bf16" else rows[p, :, :n]
        check(bool(torch.equal(got, reference(tgt[p, kept]))),
              f"K2 {prec} pre-pass: the kept rows of pair {p} differ from the plain version")
    mk.run_phases(src, tgt, bad, mk.REDUCE, scratch, o_min, o_arg, prec)
    md, am = mk.masked_argmin(src, tgt, bad, prec)
    torch.cuda.synchronize()
    check(bool(torch.equal(o_min, md) and torch.equal(o_arg, am)),
          f"K2 {prec}: the phases run apart differ from the one call")


def _k2_phase_ms(torch, mk, src, tgt, bad, prec: str, iters: int) -> tuple:
    """(pre-pass ms, main kernel + merge ms) of a mode, run apart."""
    scratch = mk._scratch(src, tgt, prec)
    o_min, o_arg = (torch.empty(src.shape[:2], dtype=dt, device=DEVICE)
                    for dt in (torch.float32, torch.int32))

    def run(phases):
        return lambda: mk.run_phases(src, tgt, bad, phases, scratch, o_min, o_arg, prec)
    run(mk.COMPACT)()
    return cuda_ms(run(mk.COMPACT), iters), cuda_ms(run(mk.REDUCE), iters)


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
    out = {"err": bf16["err"], "bf16_same": bf16["same"]}
    f32 = {"err": fp32["err"], "same": fp32["same"]}

    # each pre-pass alone, against torch.nonzero and its plain version
    _k2_prepass(torch, mk, src, tgt, bad, "bf16", lambda rows: rows.bfloat16())
    _k2_prepass(torch, mk, src, tgt, bad, "fp32", lambda rows: torch.stack(
        mk.split_tf32_plain(rows)))

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
    edges = {}
    for prec in ("bf16", "fp32"):
        edge = edges[prec] = _k2_gates(torch, mk, src_e, tgt_e, bad_e, prec, f"K2 {prec} edges")
        check(bool(torch.isinf(edge["min"][0]).all() and (edge["arg"][0] == 0).all()),
              f"K2 {prec}: a pair with every target excluded is not (+inf, 0)")
        check(bool((edge["arg"][1] == 20011).all()),
              f"K2 {prec}: a pair with one kept target missed it")
        check(bool(torch.equal(edge["arg"][3, :600],
                               torch.arange(700, 1300, dtype=torch.int32, device=DEVICE))),
              f"K2 {prec}: duplicated targets did not go to the lowest index")
    _k2_prepass(torch, mk, src_e, tgt_e, bad_e, "fp32", lambda rows: torch.stack(
        mk.split_tf32_plain(rows)))

    # the serving share: everything outside a blob of 5% excluded; a rank of
    # mesh.data=2 serving B=8 matches its 4 pairs
    blob = _blob_mask(torch, K2_PAIRS, 192, 0.05)
    half = K2_PAIRS // 2
    sparse, rank = {}, {}
    for prec in ("bf16", "fp32"):
        sparse[prec] = _k2_gates(torch, mk, src, tgt, blob, prec, f"K2 {prec} blob mask")
        rank[prec] = _k2_gates(torch, mk, src[:half], tgt[:half], blob[:half], prec,
                               f"K2 {prec} at a data-parallel rank's pairs")

    # no single PyTorch call computes a masked cosine argmin
    out.update(timed(lambda: mk.masked_argmin(src, tgt, bad, "bf16"),
                     lambda: mk.masked_argmin_plain(src, tgt, bad, "bf16"), None, iters))
    out["compact_ms"], out["reduce_ms"] = _k2_phase_ms(torch, mk, src, tgt, bad, "bf16", iters)
    out["blob_ms"] = cuda_ms(lambda: mk.masked_argmin(src, tgt, blob, "bf16"), iters)
    out["blob_compact_ms"], out["blob_reduce_ms"] = _k2_phase_ms(torch, mk, src, tgt, blob,
                                                                 "bf16", iters)
    out["host_us"] = host_us(lambda: mk.masked_argmin(src, tgt, bad, "bf16"), 50)
    # the fp32 mode and its phases
    f32.update(timed(lambda: mk.masked_argmin(src, tgt, bad, "fp32"),
                     lambda: mk.masked_argmin_plain(src, tgt, bad, "fp32"), None, iters))
    f32["compact_ms"], f32["reduce_ms"] = _k2_phase_ms(torch, mk, src, tgt, bad, "fp32", iters)
    f32["tc_again_ms"] = cuda_ms(lambda: mk.masked_argmin(src, tgt, bad, "fp32"), iters)
    f32["blob_ms"] = cuda_ms(lambda: mk.masked_argmin(src, tgt, blob, "fp32"), iters)
    f32["host_us"] = host_us(lambda: mk.masked_argmin(src, tgt, bad, "fp32"), 50)
    # one product of 32 per source and non-excluded target: at the bf16 rate
    # for the bf16 mode; for the fp32 mode three TF32 products
    kept = int((~bad).sum().item())
    kept_blob = int((~blob).sum().item())
    io = nbytes(src, tgt, bad, fp32["min"], fp32["arg"])
    out.update(bound(io, {"bf16": 2 * K2_SRC * kept * 32}))
    blob_bound = bound(io, {"bf16": 2 * K2_SRC * kept_blob * 32})
    f32.update(bound(io, {"tf32": 3 * 2 * K2_SRC * kept * 32}))
    f32_blob = bound(io, {"tf32": 3 * 2 * K2_SRC * kept_blob * 32})
    out["fp32"] = f32
    out["line"] = (
        f"{K2_PAIRS} x [{K2_SRC}, 32] x [{K2_TGT}, 32], 40% excluded ({kept} kept): "
        f"bf16 mode: min err {out['err']:.2e}, argmins same {out['bf16_same']:.6f}, "
        f"{times_txt(out)}; pre-pass {out['compact_ms']:.4f} ms (map, rows and counts equal "
        f"torch.nonzero's), main kernel {out['reduce_ms']:.4f} ms; 95% excluded "
        f"(blob): {out['blob_ms']:.4f} ms (pre-pass {out['blob_compact_ms']:.4f}, main "
        f"{out['blob_reduce_ms']:.4f}, bound {blob_bound['bound_ms']:.4f} "
        f"{blob_bound['bound_by']}), argmins same {sparse['bf16']['same']:.6f}; "
        f"host {out['host_us']:.1f} us per wrapper call | fp32 mode (split-TF32 wgmma): min "
        f"err {f32['err']:.2e}, argmins same {f32['same']:.6f}, {times_txt(f32)}, again "
        f"{f32['tc_again_ms']:.4f} ms; pre-pass {f32['compact_ms']:.4f} ms (hi/lo rows "
        f"bitwise split_tf32_plain's, map and counts torch.nonzero's), main kernel "
        f"{f32['reduce_ms']:.4f} ms; bound 3 x TF32 {f32['bound_ms']:.4f} ms; 95% excluded "
        f"(blob) {f32['blob_ms']:.4f} ms "
        f"(bound {f32_blob['bound_ms']:.4f}), argmins same {sparse['fp32']['same']:.6f}; host "
        f"{f32['host_us']:.1f} us per wrapper call | edges (S={S_e}, N={N_e}; all, all but "
        f"one, none excluded; duplicates to the lowest index) min err bf16 "
        f"{edges['bf16']['err']:.2e} / fp32 {edges['fp32']['err']:.2e}, argmins same "
        f"{edges['bf16']['same']:.6f} / {edges['fp32']['same']:.6f}; a data-parallel rank's "
        f"{half} pairs (blob): min err {rank['bf16']['err']:.2e} / {rank['fp32']['err']:.2e}, "
        f"argmins same {rank['bf16']['same']:.6f} / {rank['fp32']['same']:.6f}; two launches "
        f"bitwise equal")
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
    from oryon_tpu_torch.eval.metrics import (compute_add, compute_adds,
                                              rotation_translation_errors)
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
    # scored twice: by numpy on the host, and on the card by the port's
    # metrics in f64 (in f32 the arccos resolves 3e-4 rad and the matmul
    # expansion of ADD-S 3e-4 m at 0.8 m from the camera)
    gt = torch.tensor(Ts, dtype=torch.float64, device=DEVICE)
    errs = {}
    for k, T in res.items():
        r, t = _pose_err(T.cpu().numpy(), Ts)
        deg, cm = rotation_translation_errors(T.double(), gt)
        add = compute_add(A.double(), T.double(), gt, valid.double()).max().item()
        adds = compute_adds(A.double(), T.double(), gt, valid.double()).max().item()
        r_m, t_m = np.deg2rad(deg.max().item()), cm.max().item() / 100.0
        errs[k] = (r, t, add, adds)
        check(r < ROT_TOL and t < TRANS_TOL,
              f"{k}: rotation error {r:.2e} rad, translation {t:.2e} m "
              f"(limits {ROT_TOL}, {TRANS_TOL})")
        check(r_m < ROT_TOL and t_m < TRANS_TOL,
              f"{k}: rotation_translation_errors gives {r_m:.2e} rad, {t_m:.2e} m "
              f"(limits {ROT_TOL}, {TRANS_TOL})")
        check(abs(r_m - r) < 1e-5 and abs(t_m - t) < 1e-6,   # the metric's clamp floors at 1.4e-6 rad
              f"{k}: the port's errors ({r_m:.3e} rad, {t_m:.3e} m) differ from numpy's "
              f"({r:.3e}, {t:.3e})")
        check(0.0 <= add < ADD_TOL and 0.0 <= adds < ADD_TOL,
              f"{k}: ADD {add:.2e} m, ADD-S {adds:.2e} m (limit {ADD_TOL})")
    return {"line": ", ".join(f"{k} {r:.1e} rad / {t:.1e} m, ADD {a:.1e} ADD-S {s:.1e} m"
                              for k, (r, t, a, s) in errs.items())}


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
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


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

    # the served variants a user can choose, one counted batch each
    variants = []
    for name, solver, icp in (("ICP off", "pointdsc", False), ("RANSAC", "ransac", None)):
        other = OryonPredictor(model, pointdsc if solver == "pointdsc" else None, device=DEVICE,
                               batch_size=8, img_size=(224, 224), depth_hw=(480, 640),
                               solver=solver, icp_refine=icp)
        results, got = _counted(torch, lambda: other.predict(batch8))
        check(got["k1"] == layers and got["k2"] == 1,
              f"{name}: K1 ran {got['k1']} times, K2 {got['k2']}; expected {layers} and 1")
        variants.append(f"{name} {_check_results(results, batch8)}/8")
    return {"line": (f"build {build_s:.1f} s, first 12 requests {cold_s:.2f} s, "
                     f"{n_det}/12 detections, launches K1 {counts['k1']} K2 {counts['k2']}, "
                     f"tower cosine {cos:.6f}; warm B=8: {warm_s * 1e3:.1f} ms/batch = "
                     f"{8 / warm_s:.2f} pairs/s; stages: {stage_txt}; one batch of 8 "
                     f"(K1 {layers}, K2 1) detections: {', '.join(variants)}"),
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


def _fake_pointdsc_snapshot(rs):
    """A state dict with the key names and shapes of the published PointDSC
    snapshot (6 layers, 128 channels, Conv1d of kernel 1), values from
    ``rs`` in the manner of ``random_init_``."""
    C, sd = 128, {"sigma": np.ones(1, np.float32)}

    def conv(name, i, o):
        sd[f"{name}.weight"] = (rs.randn(o, i, 1) * i ** -0.5).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(o, np.float32)

    def bn(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.ones(c, np.float32), np.zeros(c, np.float32)
        sd[f"{name}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{name}.running_var"] = np.ones(c, np.float32)

    conv("encoder.layer0", 6, C)
    for i in range(6):
        conv(f"encoder.blocks.PointCN_layer_{i}.0", C, C)
        bn(f"encoder.blocks.PointCN_layer_{i}.1", C)
        nl = f"encoder.blocks.NonLocal_layer_{i}"
        for proj in ("projection_q", "projection_k", "projection_v"):
            conv(f"{nl}.{proj}", C, C)
        conv(f"{nl}.fc_message.0", C, C // 2)
        bn(f"{nl}.fc_message.1", C // 2)
        conv(f"{nl}.fc_message.3", C // 2, C // 2)
        bn(f"{nl}.fc_message.4", C // 2)
        conv(f"{nl}.fc_message.6", C // 2, C)
    conv("classification.0", C, 32)
    conv("classification.2", 32, 32)
    conv("classification.4", 32, 1)
    return sd


def _printed(fn):
    """(fn's result, what it printed); the text is printed again."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    sys.stdout.write(text)
    return out, text


def _pointdsc_sources(torch, tmp):
    """One set of PointDSC weights three ways: the module built from the
    flax-layout tree, a fake published snapshot, a ``native.npz``.  The two
    files load through ``build_pointdsc_solver`` and register a known rigid
    pair as the module does.  Returns (module, directory of the snapshot,
    the module's pose errors on that pair)."""
    from oryon_tpu_torch.models.convert import (convert_pointdsc, from_jax_params,
                                                save_flax_npz)
    from oryon_tpu_torch.models.pointdsc import PointDSC
    from oryon_tpu_torch.pipeline import (build_pointdsc_solver, pointdsc_native_path,
                                          pointdsc_snapshot_path)
    sd = _fake_pointdsc_snapshot(np.random.RandomState(11))
    tree = convert_pointdsc(sd)
    direct = PointDSC()
    direct.load_state_dict(from_jax_params(tree), strict=True)
    direct = direct.to(DEVICE).eval()
    snap_dir, native_dir = os.path.join(tmp, "pd_snapshot"), os.path.join(tmp, "pd_native")
    os.makedirs(os.path.dirname(pointdsc_snapshot_path(snap_dir)))
    os.makedirs(native_dir)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pointdsc_snapshot_path(snap_dir))
    save_flax_npz(pointdsc_native_path(native_dir), tree)
    A, B, valid, Ts = _rigid_case(torch, np.random.RandomState(12))
    with torch.inference_mode():
        want = direct(A, B, valid)[0]
    r, t = _pose_err(want.cpu().numpy(), Ts)
    check(r < ROT_TOL and t < TRANS_TOL, f"PointDSC on the fake snapshot's weights: {r:.2e} rad, "
                                         f"{t:.2e} m (limits {ROT_TOL}, {TRANS_TOL})")
    for directory, words in ((snap_dir, "reference snapshot"), (native_dir, "native.npz")):
        pd, text = _printed(lambda: build_pointdsc_solver(directory))
        check(words in text, f"build_pointdsc_solver({directory}) printed {text!r}")
        with torch.inference_mode():
            got = pd.to(DEVICE)(A, B, valid)[0]
        check(bool(torch.allclose(got, want, atol=1e-6)),
              f"PointDSC loaded from {words} registers differently from the module: max "
              f"|dT| = {(got - want).abs().max().item():.2e}")
    return direct, snap_dir, (r, t)


CKPT_EPOCH, CKPT_SEED = 3, 7


def _smoke_config(tmp, pd_dir, size="full", ckpt="last", exp_name="smoke"):
    """The default config tree on a temporary experiment: int8 tower,
    PointDSC + ICP, seeds that differ from the serve phase's (0).  The tiny
    size serves with RANSAC."""
    from oryon_tpu_torch.config import Config
    cfg = Config(exp_root=os.path.join(tmp, "exp"), exp_name=exp_name, use_seed=True,
                 seed=CKPT_SEED)
    cfg.eval.ckpt = ckpt
    cfg.model.size = size
    cfg.dataset.batch_size = 8
    cfg.test.solver = "pointdsc" if size == "full" else "ransac"
    cfg.pretrained.pointdsc = pd_dir
    for name in ("clip", "swin", "catseg", "vocabulary"):
        setattr(cfg.pretrained, name, os.path.join(tmp, f"no_{name}"))
    return cfg


@phase("ckpt")
def phase_ckpt(torch, pred, reqs, tmp):
    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch import infer
    from oryon_tpu_torch.infer import OryonPredictor

    pointdsc, pd_dir, (pd_r, pd_t) = _pointdsc_sources(torch, tmp)
    cfg = _smoke_config(tmp, pd_dir)
    model, batch8 = pred.model, reqs[:8]
    layers = model.vision_cfg.layers

    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(cfg, CKPT_EPOCH, model)
    save_s = time.perf_counter() - t0
    size_gb = os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e9
    direct = OryonPredictor(model, pointdsc, device=DEVICE, batch_size=8, solver="pointdsc",
                            seed=CKPT_SEED)
    want = direct.predict(batch8, return_masks=True)
    # the saved model leaves the card before the restored one arrives
    del direct
    model.to("cpu")
    torch.cuda.empty_cache()

    times = {}
    real_restore = infer.restore_checkpoint

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = real_restore(*a, **kw)
        times["load_s"] = time.perf_counter() - t0
        return out
    infer.restore_checkpoint = timed_restore
    try:
        t0 = time.perf_counter()
        restored, text = _printed(lambda: OryonPredictor.from_config(cfg))
        times["from_config_s"] = time.perf_counter() - t0
    finally:
        infer.restore_checkpoint = real_restore
    check(f"loaded checkpoint epoch {CKPT_EPOCH}" in text,
          f"from_config did not say it loaded epoch {CKPT_EPOCH}: {text!r}")
    check(text.count("missing (random init)") == 3, f"pretrained report: {text!r}")
    check(restored.device.type == torch.device(DEVICE).type and restored.pointdsc is not None,
          "from_config did not build the predictor on the card with PointDSC")
    got, counts = _counted(torch, lambda: restored.predict(batch8, return_masks=True))
    check(counts["k1"] == layers and counts["k2"] == 1 and sum(counts.values()) == layers + 1,
          f"restored model: launches {counts}, expected K1 {layers} and K2 1")
    _check_results(got, batch8)
    r_max = t_max = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(np.array_equal(g["mask_a"], w["mask_a"]) and np.array_equal(g["mask_q"], w["mask_q"]),
              f"request {i}: masks of the restored model differ from the saved model's")
        check(g["n_corrs"] == w["n_corrs"] and g["detection_valid"] == w["detection_valid"],
              f"request {i}: n_corrs {g['n_corrs']} vs {w['n_corrs']}")
        r, t = _pose_err(np.asarray(g["pose"])[None], np.asarray(w["pose"], np.float64)[None])
        r_max, t_max = max(r_max, r), max(t_max, t)
    check(r_max < ROT_TOL and t_max < TRANS_TOL,
          f"poses of the restored model differ by {r_max:.2e} rad, {t_max:.2e} m")
    del restored
    torch.cuda.empty_cache()

    # a missing epoch raises (before any forward: the tiny size will do); an
    # empty experiment warns and still answers, at full width
    try:
        OryonPredictor.from_config(_smoke_config(tmp, pd_dir, size="tiny", ckpt="7"))
        check(False, "eval.ckpt=7 with no such epoch did not raise")
    except FileNotFoundError as e:
        check("epoch 7" in str(e), f"FileNotFoundError without the epoch: {e}")
    empty, text = _printed(lambda: OryonPredictor.from_config(
        _smoke_config(tmp, pd_dir, exp_name="empty")))
    check("WARNING: eval.ckpt='last' not found" in text, f"no warning on an empty tree: {text!r}")
    _check_results(empty.predict(batch8[:2]), batch8[:2])
    return {"line": (f"{size_gb:.2f} GB state.pt saved in {save_s:.1f} s, restored in "
                     f"{times['load_s']:.1f} s (from_config whole {times['from_config_s']:.1f} s); "
                     f"8 requests: masks and n_corrs equal, poses within {r_max:.1e} rad / "
                     f"{t_max:.1e} m, launches K1 {counts['k1']} K2 {counts['k2']}; missing "
                     f"epoch raises, empty experiment warns and answers; PointDSC from "
                     f"snapshot and native.npz as the module ({pd_r:.1e} rad / {pd_t:.1e} m)"),
            "pd_dir": pd_dir}


def _write_views(tmp, rs):
    """Two pairs of views as files: png RGB, 16-bit png depth (mm)."""
    from PIL import Image
    lines = []
    for i, req in enumerate(_requests(rs, 2, ["mug", "laptop"])):
        spec = {"camera": "600,600,320,240", "prompt": req["prompt"], "id": f"pair{i}"}
        for side in ("anchor", "query"):
            rgb, depth = (os.path.join(tmp, f"cli_{i}_{side}_{kind}.png")
                          for kind in ("rgb", "depth"))
            Image.fromarray(req[side]["rgb"]).save(rgb)
            Image.fromarray(req[side]["depth"].astype(np.uint16)).save(depth)
            spec[side] = {"rgb": rgb, "depth": depth}
        lines.append(json.dumps(spec))
    path = os.path.join(tmp, "requests.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@phase("cli")
def phase_cli(torch, tmp, pd_dir, layers):
    import importlib.util

    import run_infer_torch
    overrides = [f"exp_root={os.path.join(tmp, 'exp')}", "exp_name=smoke", "eval.ckpt=last",
                 f"pretrained.pointdsc={pd_dir}", f"pretrained.vocabulary={tmp}/no_vocabulary"]
    out = os.path.join(tmp, "poses.jsonl")
    rs = np.random.RandomState(13)
    if importlib.util.find_spec("PIL") is not None:
        argv = ["--requests", _write_views(tmp, rs), *overrides, f"out={out}"]
        (_, counts), text = _printed(lambda: _counted(
            torch, lambda: run_infer_torch.main(argv)))
        how = "two png pairs from a JSONL file"
    else:
        # no image library here: the CLI's request handling, from arrays
        print("cli: skipped (no PIL on this machine)", flush=True)
        from oryon_tpu_torch.config import load_config
        reqs = _requests(rs, 2, ["mug", "laptop"])
        for i, r in enumerate(reqs):
            r["id"] = f"pair{i}"
        (_, counts), text = _printed(lambda: _counted(
            torch, lambda: run_infer_torch.serve(load_config(None, overrides), reqs, out)))
        how = "two pairs from arrays (no PIL on this machine: the files were not read)"
    check(f"loaded checkpoint epoch {CKPT_EPOCH}" in text, f"the CLI printed {text!r}")
    check(counts["k1"] == layers and counts["k2"] == 1,
          f"CLI: launches {counts}, expected K1 {layers} and K2 1")
    with open(out) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    check([ln.get("id") for ln in lines] == ["pair0", "pair1"], f"ids {lines}")
    for ln in lines:
        check(set(ln) == {"id", "prompt", "pose", "n_corrs", "detection_valid"},
              f"keys of an output line: {sorted(ln)}")
    _check_results(lines, [{"prompt": "mug"}, {"prompt": "laptop"}])
    return {"line": f"{how}: {len(lines)} poses, launches K1 {counts['k1']} K2 {counts['k2']}"}


@phase("serve_fp32")
def phase_serve_fp32(torch, pred, reqs):
    """A strict-parity run of the served model: its pipeline with
    MatchParams(precision="fp32"), whose matching is K2's fp32 mode, on one
    batch of 8, beside the serving default (bf16) on the same batch and the
    same draws."""
    from oryon_tpu_torch.config import TestConfig
    from oryon_tpu_torch.ops.matching import MatchParams
    from oryon_tpu_torch.pipeline import PipelineConfig, make_run_fn

    tc = TestConfig()
    batch, text = pred._build_batch(reqs[:8])
    layers = pred.model.vision_cfg.layers
    outs, secs, launched = {}, {}, {}
    for prec, key in (("bf16", "k2"), ("fp32", "k2fp32")):
        run = make_run_fn(pred.model, PipelineConfig(
            solver="pointdsc", icp_refine=tc.icp_refine, icp_points=tc.icp_points,
            icp_iters=tc.icp_iters, icp_trim=tc.icp_trim,
            match=MatchParams(src_capacity=5120, max_corrs=500, dist_th=0.25, precision=prec)),
            pred.pointdsc)

        def one():
            return run(batch, text, generator=torch.Generator(device=DEVICE).manual_seed(9))
        outs[prec], got = _counted(torch, one)
        launched[prec] = got
        want = {k: 0 for k in got}
        want.update({"k1": layers, key: 1})
        check(got == want, f"precision {prec}: launches {got}, expected {want}")
        t0 = time.perf_counter()
        for _ in range(TIMED_BATCHES):
            one()
        torch.cuda.synchronize()
        secs[prec] = (time.perf_counter() - t0) / TIMED_BATCHES
    a, b = outs["bf16"], outs["fp32"]
    check(bool(torch.isfinite(b.packed).all()), "fp32 matching: the poses are not finite")
    check(bool(torch.equal(a.mask_a, b.mask_a) and torch.equal(a.mask_q, b.mask_q)),
          "fp32 matching: the masks differ from the serving default's")
    same = (a.corrs == b.corrs).all(dim=-1) & (a.corr_valid == b.corr_valid)
    return {"line": (f"one batch of 8 with MatchParams(precision='fp32'): launches K1 {layers} "
                     f"K2 fp32 1 (K2 bf16 0), masks equal to the default's, correspondence "
                     f"rows equal {same.float().mean().item():.4f}, n_corrs "
                     f"{b.n_corrs.int().tolist()} against {a.n_corrs.int().tolist()}; warm batch "
                     f"{secs['fp32'] * 1e3:.1f} ms against {secs['bf16'] * 1e3:.1f} ms "
                     f"(host clock)"),
            "counts": {"k2fp32": launched["fp32"]["k2fp32"]}}


@phase("serve_small")
def phase_serve_small(torch):
    """The small model (f32 towers) served on the card: its tower goes
    through K1's f32 mode, its matching through K2."""
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import small_oryon
    model = random_init_(small_oryon(), torch.Generator().manual_seed(2))
    pred = OryonPredictor(model, device=DEVICE, batch_size=2, solver="ransac", seed=2)
    reqs = _requests(np.random.RandomState(8), 2, ["mug", "bowl"])
    results, counts = _counted(torch, lambda: pred.predict(reqs))
    _check_results(results, reqs)
    layers = model.vision_cfg.layers
    check(counts["k1"] == layers and counts["k2"] == 1 and sum(counts.values()) == layers + 1,
          f"small model: launches {counts}, expected K1 {layers} (f32 mode) and K2 1")
    names = device_kernels(torch, lambda: pred.predict(reqs),
                           lambda n: kernels_named(n, K1_F32_HEAD_KERNELS[:1]) == layers)
    head = kernels_named(names, K1_F32_HEAD_KERNELS[:1])
    old = kernels_named(names, K1_F32_OLD_KERNELS)
    check(head == layers and old == 0,
          f"small model: {head} one-block-a-head K1 kernels and {old} of the former body's")
    return {"line": f"2 requests answered, launches K1 {counts['k1']} (f32 mode, the "
                    f"one-block-a-head kernel {head} times in a profiled batch) K2 "
                    f"{counts['k2']}", "counts": counts}


EVA_HIDDEN = (2730, 2736, 2752)   # EVA02-CLIP-L's SwiGLU width; the next multiples of 8, 64


def _swiglu_ms(torch, rows: int, width: int, iters: int) -> dict:
    """{hidden: (w1 ms, w3 ms)}: device ms of the SwiGLU's products at
    ``rows`` rows, [rows, width] x [width, K] and [rows, K] x [K, width],
    bf16 with their biases, as ``models/layers.Dense`` runs them."""
    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(23)
    x = torch.randn(rows, width, generator=g, device=DEVICE).to(torch.bfloat16)
    out = {}
    for k in EVA_HIDDEN:
        w1, h = (torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
                 for shape in ((k, width), (rows, k)))
        w3 = torch.randn(width, k, generator=g, device=DEVICE).to(torch.bfloat16)
        b1, b3 = (torch.zeros(n, device=DEVICE, dtype=torch.bfloat16) for n in (k, width))
        out[k] = (cuda_ms(lambda: F.linear(x, w1, b1), iters),
                  cuda_ms(lambda: F.linear(h, w3, b3), iters))
    return out


@phase("serve_eva")
def phase_serve_eva(torch, timing_batches, iters):
    """The EVA02-CLIP towers served at B=8 in bf16: one rotary (R1) and one
    K1 launch a block, and the rotary never on its plain path."""
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import full_oryon
    from oryon_tpu_torch.models.pointdsc import PointDSC
    from oryon_tpu_torch.utils import profiling

    gen = torch.Generator().manual_seed(22)
    model = random_init_(full_oryon(vlm="eva02"), gen)
    pred = OryonPredictor(model, random_init_(PointDSC(), gen), device=DEVICE, batch_size=8,
                          img_size=(224, 224), depth_hw=(480, 640), solver="pointdsc")
    layers = model.vision_cfg.layers
    reqs = _requests(np.random.RandomState(22), 8, ["mug", "laptop"])
    profiling.take_counters()
    was = profiling.set_spans(True)
    try:
        results, counts = _counted(torch, lambda: pred.predict(reqs))
        counters = profiling.take_counters()
    finally:
        profiling.set_spans(was)
        profiling.take_spans()
    check(counts["rope"] == layers and counts["k1"] == layers and counts["k2"] == 1,
          f"EVA02 batch of 8: launches {counts}, expected R1 {layers}, K1 {layers}, K2 1")
    check("rope_plain" not in counters, f"rotations on the plain path: {counters}")
    n_det = _check_results(results, reqs)
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
    check(cos > 0.999, f"EVA02 tower cosine R1 + K1 vs plain rotary + einsum {cos:.6f}")
    warm_s, stage_txt = _warm_times(torch, pred, reqs, timing_batches)
    width = model.vision_cfg.width
    rows = 2 * 8 * (model.vision_cfg.grid ** 2 + 1)     # both views of 8 pairs
    swiglu = _swiglu_ms(torch, rows, width, iters)
    del pred, model
    torch.cuda.empty_cache()
    return {"line": (f"{n_det}/8 detections, launches R1 {counts['rope']} K1 {counts['k1']} K2 "
                     f"{counts['k2']}, rope_plain 0, tower cosine {cos:.6f}; warm B=8: "
                     f"{warm_s * 1e3:.1f} ms/batch = {8 / warm_s:.2f} pairs/s; stages: "
                     f"{stage_txt}; SwiGLU products at {rows} rows, w1 / w3 ms: "
                     + ", ".join(f"K={k} {a:.4f} / {b:.4f}" for k, (a, b) in swiglu.items())),
            "counts": {"rope": counts["rope"]}}


# A REAL275-format tree for the eval phase: two box-shaped objects (the
# second with a 180-degree symmetry), six views each at 480 x 640 with the
# REAL275 intrinsics, eight anchor/query pairs a class, scene depth rendered
# from the ground-truth pose over a background plane with millimetre noise.
EVAL_HW = (480, 640)
EVAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]])
EVAL_CLASSES = (("box_1", 1, (100.0, 80.0, 60.0), ["box", "carton", "cardboard box"], {}),
                ("tall_1", 2, (60.0, 60.0, 120.0), ["bottle", "can", "tall can"],
                 {"symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]}))
EVAL_VIEWS = 6
EVAL_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 4), (2, 5), (3, 4), (4, 5))
EVAL_SPLIT, EVAL_WINDOW, EVAL_BATCH = "eval_split", 256, 8
EVAL_REPEATS, EVAL_FILL = 8, 2    # timed sweeps: the split 8 times over, 2 fill batches
# ground-truth correspondences land on featmap pixels (2.5 px of the 480 x
# 640 frame) and the depth has 2 mm noise; RANSAC then ICP on the GT masks
# (the CPU run of the same steps: 0.025 rad, 0.012 m at worst): rad, m
DEBUG_ROT_TOL, DEBUG_TRANS_TOL = 0.1, 0.03


def _box_mesh(size, max_edge=20.0):
    """A closed box of ``size`` mm centred on the origin, subdivided until
    every edge is at most ``max_edge`` mm: (vertices [V, 3] mm, faces)."""
    from oryon_tpu_torch.eval.renderer import subdivide_mesh
    h = np.asarray(size) / 2.0
    V = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * h
    F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return subdivide_mesh(V, F, max_edge)


def _rotation(rs, max_angle=np.pi):
    """A random rotation: axis uniform, angle uniform in [0, max_angle)."""
    a = rs.randn(3)
    a /= np.linalg.norm(a)
    A = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = rs.uniform(0, max_angle)
    return np.eye(3) + np.sin(th) * A + (1 - np.cos(th)) * (A @ A)


def _random_pose(rs, base):
    """A view of an object: its class's ``base`` rotation turned by up to
    35 degrees (the views of a scene overlap, as a sequence's do), and a
    translation that keeps it in view, 500-700 mm from the camera (mm)."""
    t = np.array([rs.uniform(-60, 60), rs.uniform(-40, 40), rs.uniform(500, 700)])
    return _rotation(rs, np.deg2rad(35)) @ base, t


def write_real275_tree(root, rs, device, split=EVAL_SPLIT, views=EVAL_VIEWS,
                       pairs=EVAL_PAIRS, hw=EVAL_HW, scale=1.0):
    """Write the REAL275 layout ``data.datasets.NocsReader`` reads, with
    ground-truth relative poses and correspondences in the fixed split;
    ``scale`` multiplies the objects' sizes.  Depth and masks are rendered
    by the port's scatter rasteriser on ``device``.  Returns the number of
    pairs."""
    import pickle

    import torch
    from PIL import Image

    from oryon_tpu_torch.data.meshio import load_nocs_object
    from oryon_tpu_torch.data.templates import CLIP_TEMPLATES
    from oryon_tpu_torch.eval.renderer import max_screen_footprint, pad_mesh, render_depth
    H, W = hw
    K = torch.tensor(EVAL_K, dtype=torch.float32, device=device)
    models = os.path.join(root, "obj_models", "real_test")
    os.makedirs(models)
    os.makedirs(os.path.join(root, "gts", "real_test"))
    infos, names, lines, annots = {}, {}, [], {}
    for ci, (obj, cls_id, size, words, sym) in enumerate(EVAL_CLASSES):
        V, F = _box_mesh(np.asarray(size) * scale)
        base = os.path.join(models, obj)
        np.savetxt(base + "_vertices.txt", V / 1000.0, fmt="%.6f")
        np.savetxt(base + "_normals.txt", np.zeros_like(V), fmt="%.1f")
        with open(base + ".obj", "w") as f:
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in F)
        model = load_nocs_object(base)          # the values the reader will see
        mesh = pad_mesh(model["pts"], model["faces"] - 1, device=device)
        pts = model["pts"]
        diam = float(np.linalg.norm(pts[:, None] - pts[None], axis=-1).max())
        infos[obj], names[obj] = {"diameter": diam, **sym}, words
        scene = ci + 1
        sdir = os.path.join(root, "split", "real_test", f"scene_{scene}")
        os.makedirs(sdir)
        poses, renders, base = [], [], _rotation(rs)
        for img in range(views):
            R, t = _random_pose(rs, base)
            Rt, tt = (torch.tensor(a, dtype=torch.float32, device=device) for a in (R, t))
            check(float(max_screen_footprint(mesh, Rt, tt, K)) < 32, "tree: triangle too large")
            d = render_depth(mesh, Rt, tt, K, hw, tile=32).cpu().numpy()
            check((d > 0).sum() > 500, f"tree: view {img} of {obj} shows {(d > 0).sum()} px")
            stem = os.path.join(sdir, f"{img:04d}")
            scene_d = np.where(d > 0, d, 900.0) + rs.randn(H, W) * 2.0
            Image.fromarray(np.clip(scene_d, 0, 65535).astype(np.uint16)).save(stem + "_depth.png")
            Image.fromarray(np.where(d > 0, 1, 255).astype(np.uint8)).save(stem + "_mask.png")
            rgb = rs.randint(0, 256, (H, W, 3))
            rgb[d > 0] = (rgb[d > 0] // 4 + np.array([200, 120, 40]) * (ci + 1) // 2) % 256
            Image.fromarray(rgb.astype(np.uint8)).save(stem + "_color.png")
            with open(stem + "_meta.txt", "w") as f:
                f.write(f"1 {cls_id} {obj}\n")
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, t / 1000.0
            with open(os.path.join(root, "gts", "real_test",
                                   f"results_real_test_{scene}_{img}.pkl"), "wb") as f:
                pickle.dump({"gt_RTs": T[None]}, f)
            poses.append((R, t))
            renders.append(d)
        for ia, iq in pairs:
            (Ra, ta), (Rq, tq) = poses[ia], poses[iq]
            Rr = Rq @ Ra.T
            tr = tq - Rr @ ta                    # mm
            ys, xs = np.nonzero(renders[ia] > 0)
            take = rs.choice(len(ys), min(400, len(ys)), replace=False)
            y, x = ys[take], xs[take]
            z = renders[ia][y, x]
            pa = np.stack([(x - EVAL_K[0, 2]) * z / EVAL_K[0, 0],
                           (y - EVAL_K[1, 2]) * z / EVAL_K[1, 1], z], 1)
            pq = pa @ Rr.T + tr
            u = np.round(pq[:, 0] / pq[:, 2] * EVAL_K[0, 0] + EVAL_K[0, 2]).astype(int)
            v = np.round(pq[:, 1] / pq[:, 2] * EVAL_K[1, 1] + EVAL_K[1, 2]).astype(int)
            ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
            ok[ok] &= np.abs(renders[iq][v[ok], u[ok]] - pq[ok, 2]) < 5.0   # visible
            rel = np.eye(4)
            rel[:3, :3], rel[:3, 3] = Rr, tr
            key = f"{scene}_{ia}_{scene}_{iq}_{cls_id}_{obj}"
            annots[key] = {"gt": rel, "corrs": np.stack([y[ok], x[ok], v[ok], u[ok]], 1)}
            lines.append(f"test, {scene} {ia}, {scene} {iq}, {cls_id} {obj}\n")
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(infos, f)
    with open(os.path.join(root, "obj_names.json"), "w") as f:
        json.dump(names, f)
    with open(os.path.join(root, "templates.json"), "w") as f:
        json.dump(list(CLIP_TEMPLATES), f)
    sp = os.path.join(root, "fixed_split", split)
    os.makedirs(sp)
    with open(os.path.join(sp, "instance_list.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(sp, "annots.pkl"), "wb") as f:
        pickle.dump(annots, f)
    return len(lines)


TRAIN_SPLIT = "train_split"
TRAIN_CLASSES = ((3, "abc123", "chair,seat,stool", "chair_model"),
                 (7, "def456", "mug,cup,coffee mug", "mug_model"))


def write_shapenet6d_tree(root, rs, pairs, hw=EVAL_HW, split=TRAIN_SPLIT):
    """Write the ShapeNet6D layout ``data.datasets.Shapenet6DReader`` reads:
    ``pairs`` pairs of two images each, made by ``data.synthetic.
    synthetic_pair`` at ``hw`` (a textured depth blob, moved by a random
    pose), the classes of ``TRAIN_CLASSES`` in turn, with the relative poses
    and correspondences in the fixed split.  Returns the number of pairs."""
    import pickle

    from PIL import Image

    from oryon_tpu_torch.data.synthetic import DEFAULT_K, synthetic_pair
    from oryon_tpu_torch.data.templates import CLIP_TEMPLATES
    for sub in ("rgb", "mask", "depth"):
        os.makedirs(os.path.join(root, "raw_data", sub))
    scene_gt, lines, annots = {}, [], {}
    for p in range(pairs):
        cls_id, obj, _, _ = TRAIN_CLASSES[p % len(TRAIN_CLASSES)]
        it = synthetic_pair(rs, hw, hw)
        ia, iq = 2 * p, 2 * p + 1
        for img, side in ((ia, "a"), (iq, "q")):
            stem = f"{img:06d}"
            Image.fromarray((it[f"rgb_{side}"] * 255).astype(np.uint8)).save(
                os.path.join(root, "raw_data", "rgb", stem + ".jpg"))
            Image.fromarray(it[f"mask_{side}"].astype(np.uint8)).save(
                os.path.join(root, "raw_data", "mask", stem + ".png"))
            Image.fromarray(np.clip(it[f"depth_{side}"], 0, 65535).astype(np.uint16)).save(
                os.path.join(root, "raw_data", "depth", stem + ".png"))
            scene_gt[img] = {"K": DEFAULT_K.reshape(3, 3).astype(np.float64),
                             "obj_info_lst": [{}, {"cls_id": cls_id,
                                                   "RT": it[f"pose_{side}"][:3]}]}
        rel = it["rel_pose"].astype(np.float64)
        rel[:3, 3] *= 1000.0                     # the annotations hold mm
        name = f"obj{cls_id}"
        annots[f"0_{ia}_0_{iq}_{cls_id}_{name}"] = {
            "gt": rel, "corrs": it["corrs"][it["corr_valid"]]}
        lines.append(f"train, 0 {ia}, 0 {iq}, {cls_id} {name}\n")
    with open(os.path.join(root, "scene_gt.pkl"), "wb") as f:
        pickle.dump(scene_gt, f)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("fullId,x,category,wnlemmas,name,z\n")
        f.writelines(f'wss.{oid},0,{words.split(",")[0]},"{words}",{model},0\n'
                     for _, oid, words, model in TRAIN_CLASSES)
    with open(os.path.join(root, "objnm2clsid.json"), "w") as f:
        json.dump({f"{oid}_0": cls_id for cls_id, oid, _, _ in TRAIN_CLASSES}, f)
    with open(os.path.join(root, "templates.json"), "w") as f:
        json.dump(list(CLIP_TEMPLATES), f)
    sp = os.path.join(root, "fixed_split", split)
    os.makedirs(sp)
    with open(os.path.join(sp, "instance_list.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(sp, "annots.pkl"), "wb") as f:
        pickle.dump(annots, f)
    return len(lines)


class _NullEvaluator:
    """Registers nothing: the sweep's time without scoring."""
    metrics: dict = {}

    def register_test_batch(self, *a, **kw):
        pass

    def register_test_failure(self, *a, **kw):
        pass


def _eval_overrides(tmp, pd_dir, name):
    return [f"dataset.root={tmp}", f"dataset.test.name={name}",
            f"dataset.test.split={EVAL_SPLIT}", "model.size=full", "model.quant=int8",
            f"dataset.batch_size={EVAL_BATCH}", "test.solver=pointdsc",
            f"pretrained.pointdsc={pd_dir}", "compute_vsd=true",
            f"eval.vsd_window={EVAL_WINDOW}", f"exp_root={os.path.join(tmp, 'exp')}",
            "exp_name=smoke", "eval.ckpt=last", "use_seed=true", "seed=5",
            *[f"pretrained.{k}={tmp}/no_{k}" for k in ("clip", "swin", "catseg", "vocabulary")]]


class _Repeated:
    """The dataset's split ``times`` over: a sweep long enough to reach a
    steady state.  Sorted by class, its batches stay one class each."""

    def __init__(self, ds, times: int):
        self.ds, self.instances = ds, list(ds.instances) * times

    def __len__(self) -> int:
        return len(self.instances)

    def get_pair(self, index: int, train: bool = False):
        return self.ds.get_pair(index % len(self.ds), train=train)

    def collate(self, pairs, train: bool = False):
        return self.ds.collate(pairs, train=train)


class _TimedScoring:
    """``evaluator`` with the seconds of each ``register_test_batch`` call
    (the scoring in the drain thread, its fetches included) kept."""

    def __init__(self, evaluator):
        self.evaluator, self.seconds = evaluator, []

    def __getattr__(self, name):
        return getattr(self.evaluator, name)

    def register_test_batch(self, *a, **kw):
        t0 = time.perf_counter()
        self.evaluator.register_test_batch(*a, **kw)
        self.seconds.append(time.perf_counter() - t0)


def _split_sweep(torch, sw, evaluator, batches=None) -> dict:
    """One sweep of the split repeated ``EVAL_REPEATS`` times through the
    test loop, from the loader (or from ``batches``, collated beforehand).

    The calling thread's time between two batches is split into the wait in
    ``next()`` on the loader, the pipeline call (dispatch, which returns
    once the host has enqueued the batch) and the rest (chiefly the wait for
    room in the drain thread's queue).  Medians over the batches past the
    first ``EVAL_FILL`` (the pipeline's fill), in ms; ``pairs_s`` is the
    steady-state rate, ``whole_pairs_s`` the whole sweep's."""
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.pipeline import run_test_epoch
    ds = _Repeated(sw.ds, EVAL_REPEATS)
    src = iter(batches if batches is not None
               else PrefetchLoader(ds, EVAL_BATCH, sort_by_class=True))
    got, wait, disp = [], [], []

    def timed_batches():
        while True:
            t0 = time.perf_counter()
            b = next(src, None)
            if b is None:
                return
            got.append(time.perf_counter())
            wait.append(got[-1] - t0)
            yield b

    def pipe(batch, text_emb):
        t0 = time.perf_counter()
        out = sw.pipe(batch, text_emb)
        disp.append(time.perf_counter() - t0)
        return out

    scoring = _TimedScoring(evaluator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = run_test_epoch(pipe, ds, scoring, EVAL_BATCH, csv_fp=io.StringIO(),
                       text_cache=sw.text_cache, loader=timed_batches())
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    check(n == len(ds), f"sweep registered {n} of {len(ds)} pairs")
    steady = range(EVAL_FILL, len(got) - 1)
    period = [got[i + 1] - got[i] for i in steady]
    med = lambda xs: float(np.median(xs)) * 1e3   # noqa: E731
    return {"pairs_s": EVAL_BATCH * 1e3 / med(period), "whole_pairs_s": n / whole,
            "batches": len(got), "period_ms": med(period),
            "wait_ms": med([wait[i + 1] for i in steady]),
            "dispatch_ms": med([disp[i] for i in steady]),
            "rest_ms": med([got[i + 1] - got[i] - disp[i] - wait[i + 1] for i in steady]),
            "score_ms": med(scoring.seconds[EVAL_FILL:]) if scoring.seconds else 0.0}


def _split_txt(r: dict) -> str:
    return (f"{r['pairs_s']:.2f} pairs/s steady ({r['whole_pairs_s']:.2f} whole, "
            f"{r['batches']} batches), a batch {r['period_ms']:.1f} ms = loader wait "
            f"{r['wait_ms']:.1f} + dispatch {r['dispatch_ms']:.1f} + rest {r['rest_ms']:.1f}"
            + (f", scoring {r['score_ms']:.1f} in the drain thread" if r["score_ms"] else ""))


def _scored(torch, sw, batch, pred, device):
    """One batch scored with ``pred`` [B, 4, 4] as the absolute and relative
    prediction, by a fresh BatchedEvaluator on ``device``: (evaluator,
    seconds of the scoring call)."""
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    ev = BatchedEvaluator("Ours", vsd_window=EVAL_WINDOW, device=device)
    ev.add_object_info(sw.ds.reader.object_info())
    ev.init_test()
    B = len(batch.cls_id)
    depth = batch.query.eval_depth.to(device)
    t0 = time.perf_counter()
    ev.register_test_batch(np.ones(B), np.ones(B), batch.query.pose.cpu().numpy(), pred, pred,
                           list(batch.cls_id), batch.query.camera.cpu().numpy(), depth,
                           list(batch.instance_id), depth_index=np.arange(B))
    return ev, time.perf_counter() - t0


@phase("eval")
def phase_eval(torch, tmp, pd_dir, layers, smi_line):
    import dataclasses

    import run_test_torch
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.eval.renderer import render_depth_window
    from oryon_tpu_torch.ops.matching import nn_correspondences_anchors
    from oryon_tpu_torch.ops.resize import resize_mask_nearest
    from oryon_tpu_torch.pipeline import _featmap_coords, make_run_fn
    name = "nocs_smoke"
    t0 = time.perf_counter()
    n_pairs = write_real275_tree(os.path.join(tmp, name), np.random.RandomState(21), DEVICE)
    tree_s = time.perf_counter() - t0
    argv = _eval_overrides(tmp, pd_dir, name) + ["--device", DEVICE]
    t0 = time.perf_counter()
    (sw, counts), text = _printed(lambda: _counted(torch, lambda: run_test_torch.main(argv)))
    cold_s = time.perf_counter() - t0
    for want in (f"TESTING on {name}, split {EVAL_SPLIT}. Samples: {n_pairs}",
                 f"loaded checkpoint epoch {CKPT_EPOCH}", "Ours &", f"registered {n_pairs} pairs"):
        check(want in text, f"run_test_torch did not print {want!r}")
    check(counts["k1"] == 2 * layers and counts["k2"] == 2 and sum(counts.values()) == 2 * layers + 2,
          f"sweep of {n_pairs} pairs: launches {counts}, expected K1 {2 * layers} and K2 2")
    with open(sw.csv) as f:
        rows = f.read().splitlines()
    check(len(rows) == n_pairs and all(len(r.split(",")) == 5 for r in rows),
          f"CSV: {len(rows)} lines, fields {[len(r.split(',')) for r in rows]}")
    with open(sw.json) as f:
        saved = json.load(f)
    ref = BatchedEvaluator("Ours")
    ref.init_test()
    check(set(saved) == set(ref.metrics) | set(ref.counts), f"JSON keys {sorted(saved)}")
    means = sw.evaluator.get_means()
    check(all(np.isfinite(v) for v in means.values()), f"means {means}")
    cfgs = [f for f in os.listdir(os.path.dirname(sw.csv)) if f.startswith("config_")]
    check(len(cfgs) == 1, f"config files {cfgs}")

    # the ground-truth pose as the prediction, then one 5 cm off
    batch = next(iter(PrefetchLoader(sw.ds, EVAL_BATCH)))
    gt = batch.query.pose.cpu().numpy()
    ev, _ = _scored(torch, sw, batch, gt, DEVICE)
    _, score_s = _scored(torch, sw, batch, gt, DEVICE)       # warm
    m = ev.get_means()
    check(m["R error"] < 0.03 and m["T error"] < 1e-4 and m["ADD(S)-0.1d"] == 1.0
          and m["MSSD"] == 1.0 and m["MSPD"] == 1.0 and m["VSD"] == 1.0,
          f"the ground-truth pose scores {m}")
    off = gt.copy()
    off[:, 0, 3] += 0.05
    ev_dev, _ = _scored(torch, sw, batch, off, DEVICE)
    ev_cpu, _ = _scored(torch, sw, batch, off, "cpu")
    md, mc = ev_dev.get_means(), ev_cpu.get_means()
    for k in ("MSSD", "MSPD", "ADD(S)-0.1d", "T error", "VSD"):
        tol = 0.02 if k == "VSD" else 1e-5    # a render may differ at a silhouette pixel
        check(abs(md[k] - mc[k]) <= tol, f"5 cm off: {k} {md[k]} on the card, {mc[k]} on the CPU")
    check(md["MSSD"] < 1.0 and md["VSD"] < 1.0, f"5 cm off still scores {md}")

    # timings: one window render of a batch's poses, steady sweeps
    c = ev_dev._tensors(batch.cls_id[0])
    R = torch.as_tensor(gt[:, :3, :3], device=DEVICE)
    t = torch.as_tensor(gt[:, :3, 3] * 1000, device=DEVICE)
    K = batch.query.camera.reshape(-1, 3, 3).float()
    origin = torch.zeros((len(gt), 2), dtype=torch.int64, device=DEVICE)
    render_ms = cuda_ms(lambda: render_depth_window(
        c["mesh"], R, t, K, origin, (EVAL_WINDOW, EVAL_WINDOW),
        BatchedEvaluator.RENDER_CHUNK), 3) / len(gt)
    ev_w = BatchedEvaluator("Ours", vsd_window=EVAL_WINDOW, device=DEVICE)
    ev_w.add_object_info(sw.ds.reader.object_info())
    ev_w.init_test()
    with torch.inference_mode():
        held = list(PrefetchLoader(_Repeated(sw.ds, EVAL_REPEATS), EVAL_BATCH,
                                   sort_by_class=True))
    # the loader's sweeps bracketed by two from the collated batches
    preloaded = [_split_sweep(torch, sw, _NullEvaluator(), held)]
    scored = _split_sweep(torch, sw, ev_w)
    unscored = _split_sweep(torch, sw, _NullEvaluator())
    preloaded.append(_split_sweep(torch, sw, _NullEvaluator(), held))
    del held

    # debug_valid: ground-truth correspondences, one batch, K2 not launched.
    # RANSAC (the fake PointDSC weights classify inliers at random) and ICP
    # on the ground-truth masks (the random model's masks are noise) must
    # find the ground-truth relative pose up to the featmap's quantisation
    dbg = make_run_fn(sw.model, dataclasses.replace(
        sw.pcfg, debug_valid=True, solver="ransac", mask_source="oracle"), None)
    text_emb = sw.text_cache(batch.cls_id, batch.prompt_ids)
    out, dcounts = _counted(torch, lambda: dbg(batch, text_emb, generator=torch.Generator(
        device=DEVICE).manual_seed(3)))
    check(dcounts["k1"] == layers and dcounts["k2"] == 0, f"debug_valid launches {dcounts}")
    packed = out.packed.cpu().numpy()
    check(np.isfinite(packed).all() and (packed[:, 32] >= 4).all(),
          f"debug_valid: n_corrs {packed[:, 32]}")
    rel_err = _pose_err(packed[:, :16].reshape(-1, 4, 4), batch.rel_pose.cpu().numpy())
    check(rel_err[0] < DEBUG_ROT_TOL and rel_err[1] < DEBUG_TRANS_TOL,
          f"debug_valid: relative poses off by {rel_err[0]:.3f} rad, {rel_err[1]:.4f} m")

    # nn_correspondences_anchors from the ground-truth anchor pixels
    with torch.inference_mode():
        fo = sw.model(batch.anchor.rgb, batch.query.rgb, None, text_emb)
        FH, FW = fo.featmap_a.shape[1:3]
        anchors = _featmap_coords(batch.corrs, batch.anchor.rgb.shape[1:3], (FH, FW))[..., :2]
        mask_q = resize_mask_nearest(batch.query.mask, (FH, FW))
        rows, acounts = _counted(torch, lambda: nn_correspondences_anchors(
            fo.featmap_a, fo.featmap_q, anchors, mask_q))
        rows_cpu = nn_correspondences_anchors(fo.featmap_a.cpu(), fo.featmap_q.cpu(),
                                              anchors.cpu(), mask_q.cpu())
    check(acounts["k2"] == 1, f"nn_correspondences_anchors launches {acounts}")
    same = float((rows.cpu() == rows_cpu).all(-1).float().mean())
    check(same > 0.99, f"nn_correspondences_anchors: {same:.4f} of rows equal the CPU's")
    return {"line": (f"{smi_line}: {n_pairs}-pair REAL275-format tree (2 classes, "
                     f"{EVAL_HW[0]}x{EVAL_HW[1]}) written in {tree_s:.1f} s; run_test_torch.main "
                     f"at full width (int8, PointDSC, ICP, VSD window {EVAL_WINDOW}) in "
                     f"{cold_s:.1f} s cold: {n_pairs} CSV lines, JSON keys as BatchedEvaluator's, "
                     f"AR {means['AR']:.3f}, launches K1 {counts['k1']} K2 {counts['k2']}; "
                     f"sweeps of the split {EVAL_REPEATS} times over: with scoring "
                     f"{_split_txt(scored)}; without scoring {_split_txt(unscored)}; "
                     f"batches collated beforehand, no scoring, before "
                     f"{_split_txt(preloaded[0])} and after {_split_txt(preloaded[1])}; "
                     f"window render "
                     f"{render_ms:.3f} ms a pose, scoring {score_s * 1e3:.1f} ms a batch of "
                     f"{len(gt)}; ground-truth pose: R {m['R error']:.3f} deg, T "
                     f"{m['T error']:.2e} cm, ADD(S)/MSSD/MSPD/VSD recall 1; 5 cm off: MSSD "
                     f"{md['MSSD']:.3f} MSPD {md['MSPD']:.3f} VSD {md['VSD']:.3f} (CPU "
                     f"{mc['VSD']:.3f}); debug_valid (RANSAC, ICP on the GT masks): K1 "
                     f"{dcounts['k1']} K2 0, relative poses within {rel_err[0]:.3f} rad / "
                     f"{rel_err[1]:.4f} m of the ground truth; "
                     f"nn_correspondences_anchors K2 {acounts['k2']}, rows equal the CPU's "
                     f"{same:.4f}"),
            "sweeps": {"scored": scored, "unscored": unscored, "preloaded": preloaded},
            "csv": sw.csv, "means": means,
            "render_ms": render_ms, "score_ms": score_s * 1e3}


TRAIN_PAIRS, TRAIN_BATCH = 64, 32   # two steps an epoch at the trainer's default B
TRAIN_NAME = "shapenet6d_smoke"
TRAIN_REPEATS, TRAIN_FILL = 8, 3    # timed steps: the tree 8 times over, 3 fill steps
OVERFIT_BATCH, OVERFIT_STEPS = 8, 10
GRAD_COS_BOUND, GRAD_LOSS_TOL = 0.999, 1e-2   # fused vs einsum tower (bf16 logits there)


def write_train_tree(tmp) -> dict:
    """The train phase's ShapeNet6D-format tree, written once for the native
    and train phases: its pair count and the seconds it took."""
    t0 = time.perf_counter()
    pairs = write_shapenet6d_tree(os.path.join(tmp, TRAIN_NAME), np.random.RandomState(31),
                                  TRAIN_PAIRS)
    return {"pairs": pairs, "seconds": time.perf_counter() - t0}


def _train_argv(tmp, pd_dir, *extra):
    return [f"dataset.root={tmp}", f"dataset.train.name={TRAIN_NAME}",
            f"dataset.train.split={TRAIN_SPLIT}", "dataset.test.name=nocs_smoke",
            f"dataset.test.split={EVAL_SPLIT}", "model.size=full", "model.attn_impl=fused",
            "model.train_quant=none", f"dataset.batch_size={TRAIN_BATCH}",
            "training.freq_save=1", "training.freq_valid=1", f"pretrained.pointdsc={pd_dir}",
            f"exp_root={os.path.join(tmp, 'exp')}", "exp_name=train_smoke", "use_seed=true",
            "seed=7", *[f"pretrained.{k}={tmp}/no_{k}" for k in ("clip", "swin", "catseg",
                                                                   "vocabulary")],
            *extra, "--device", DEVICE]


def _epoch_losses(text: str) -> dict:
    """{epoch: {name: value}} of the trainer's 'epoch N: k=v ...' lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("epoch ") and ": " in line:
            head, body = line.split(": ", 1)
            out[int(head.split()[1])] = {k: float(v) for k, v in
                                         (kv.split("=") for kv in body.split())}
    return out


def _split_steps(torch, tr):
    """Train steps over the tree ``TRAIN_REPEATS`` times over, through one
    ``PrefetchLoader`` (one worker thread, as the trainer's).  Each step is
    split by CUDA events into augment, forward + loss, backward and
    optimizer, and by the host clock into the wait in ``next()`` on the
    loader and the step.  Medians over the steps past the first
    ``TRAIN_FILL`` (the loader's fill), in ms; ``pairs_s`` is the steady
    rate (B over the median period between two batches), ``whole_pairs_s``
    the whole window's.  Also returns the first step's launch counts."""
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.data.pair_batch import train_fields
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    loader = PrefetchLoader(_Repeated(tr.train_ds, TRAIN_REPEATS), TRAIN_BATCH, shuffle=True,
                            drop_last=True, seed=0, train=True)
    it, rows, got, counts = iter(loader), [], [], None
    torch.cuda.synchronize()
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        got.append(t1)
        batch = train_fields(batch._replace(text_emb=tr.text_cache(batch.prompt_ids)))
        events: list = []
        reset_launch_counts()
        tr.step_fn(tr.state, batch, tr.generator, stage_events=events)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = counts or launch_counts()
        ms = {n1: e0.elapsed_time(e1) for (_, e0), (n1, e1) in zip(events, events[1:])}
        ms.update(wait=(t1 - t0) * 1e3, step=(t2 - t1) * 1e3)
        rows.append(ms)
    whole = time.perf_counter() - start
    check(len(rows) == len(loader) > TRAIN_FILL + 2,
          f"{len(rows)} of {len(loader)} timed steps")
    steady = range(TRAIN_FILL, len(rows))
    med = {k: float(np.median([rows[i][k] for i in steady])) for k in rows[0]}
    med["period"] = float(np.median([got[i] - got[i - 1] for i in steady])) * 1e3
    return {"ms": med, "counts": counts, "steps": len(rows),
            "pairs_s": TRAIN_BATCH * 1e3 / med["period"],
            "whole_pairs_s": len(rows) * TRAIN_BATCH / whole}


NATIVE_VIEW, NATIVE_OUT = (480, 640), (224, 224)   # a loader view, the model's input
NATIVE_CALLS = 20                 # timed calls of a resize a version and round
NATIVE_ROUNDS = 3                 # loader passes a version, interleaved


@contextlib.contextmanager
def _loader_parts(ds, plain: bool):
    """While open, the loader worker's seconds reading (the reader's
    ``get_item``), augmenting (``augment_pair``) and collating are summed in
    the yielded dict, with the calls of the two uint8 resizes that
    ``data/augment.py`` sends to the library; with ``plain`` the numpy plain
    versions stand in for the library there (the parent's data path)."""
    from oryon_tpu_torch.data import datasets
    from oryon_tpu_torch.utils import native
    acc = {"read": 0.0, "augment": 0.0, "collate": 0.0, "bilinear": 0, "nearest": 0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return run

    def counted(key, fn):
        def run(*a, **kw):
            acc[key] += 1
            return fn(*a, **kw)
        return run

    saved = [(datasets, "augment_pair"), (native, "resize_bilinear_u8"),
             (native, "resize_nearest_u8")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    datasets.augment_pair = timed("augment", datasets.augment_pair)
    native.resize_bilinear_u8 = counted("bilinear", native.resize_bilinear_plain if plain
                                        else native.resize_bilinear_u8)
    native.resize_nearest_u8 = counted("nearest", native.resize_nearest_plain if plain
                                       else native.resize_nearest_u8)
    ds.reader.get_item = timed("read", ds.reader.get_item)
    ds.collate = timed("collate", ds.collate)
    try:
        yield acc
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del ds.reader.get_item, ds.collate


def _loader_pass(ds) -> list:
    """Host ms of each batch of one ``PrefetchLoader`` pass as the trainer
    makes it (B=32, shuffled, ``train=True``), the consumer taking each batch
    as it arrives: the worker's time a batch."""
    from oryon_tpu_torch.data.loader import PrefetchLoader
    ms, t0 = [], time.perf_counter()
    for _ in PrefetchLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0,
                            train=True):
        t1 = time.perf_counter()
        ms.append((t1 - t0) * 1e3)
        t0 = t1
    return ms


def _host_ms(fn, *args) -> float:
    t0 = time.perf_counter()
    for _ in range(NATIVE_CALLS):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / NATIVE_CALLS


@phase("native")
def phase_native(torch, tmp, pd_dir, smi_line, tree):
    import types

    import run_train_torch
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.models.clip import ClipTextConfig
    from oryon_tpu_torch.models.fusion import FusionConfig
    from oryon_tpu_torch.utils import native

    # the library from the port's own source, built into an empty directory
    here = os.path.dirname(os.path.abspath(__file__))
    check(os.path.relpath(native.SOURCE, here) == "oryon_tpu_torch/native/oryon_native.cpp",
          f"the library's source is {native.SOURCE}")
    build = os.path.join(tmp, "host_build")
    os.makedirs(build)
    native.BUILD_DIR, native._lib = build, None
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    built = os.listdir(build)
    check(len(built) == 1 and built[0].startswith("liboryon_native_")
          and built[0].endswith(".so"), f"the build left {built}")

    # codecs and resizes against the plain versions at the loader's sizes
    rs = np.random.RandomState(41)
    mask = (rs.rand(*NATIVE_VIEW) > 0.7).astype(np.uint8)
    runs = native.rle_encode(mask)
    check(np.array_equal(runs, native.rle_encode_plain(mask))
          and np.array_equal(native.rle_decode(runs, mask.shape), mask)
          and np.array_equal(native.rle_decode_plain(runs, mask.shape), mask),
          "RLE differs from the plain version or does not round-trip")
    check(np.array_equal(native.resize_nearest_u8(mask, NATIVE_OUT),
                         native.resize_nearest_plain(mask, NATIVE_OUT)),
          "the nearest resize differs from the plain version")
    view = (rs.rand(*NATIVE_VIEW, 3) * 256).astype(np.uint8)
    gray = (rs.rand(*NATIVE_VIEW) * 256).astype(np.uint8)
    diff = {}
    for name, img in (("view", view), ("2-D", gray)):
        got = native.resize_bilinear_u8(img, NATIVE_OUT).astype(int)
        ref = native.resize_bilinear_plain(img, NATIVE_OUT).astype(int)
        check(got.shape == ref.shape and np.abs(got - ref).max() <= 1,
              f"bilinear {name}: more than 1 LSB from the plain version")
        diff[name] = (int((got != ref).sum()), got.size)
    host = {k: [] for k in ("lib view", "plain view", "lib mask", "plain mask")}
    for _ in range(NATIVE_ROUNDS):
        host["lib view"].append(_host_ms(native.resize_bilinear_u8, view, NATIVE_OUT))
        host["plain view"].append(_host_ms(native.resize_bilinear_plain, view, NATIVE_OUT))
        host["lib mask"].append(_host_ms(native.resize_nearest_u8, mask, NATIVE_OUT))
        host["plain mask"].append(_host_ms(native.resize_nearest_plain, mask, NATIVE_OUT))
    host = {k: float(np.median(v)) for k, v in host.items()}

    # the loader alone over the train tree, as the trainer builds it (uint8
    # RGB cache, host augmentation off, collate to the device), with the
    # library and with the plain versions in turns
    overrides = [a for a in _train_argv(tmp, pd_dir) if "=" in a and not a.startswith("--")]
    cfg = load_config(None, overrides)
    dims = types.SimpleNamespace(text_cfg=ClipTextConfig(), fusion_cfg=FusionConfig())
    ds, _ = run_train_torch._datasets(cfg, dims, torch.device(DEVICE),
                                      bool(cfg.augs.rgb.device))
    check(ds.reader._rgb_u8 and len(ds) == tree["pairs"],
          "the training reader does not cache RGB as uint8")
    _loader_pass(ds)                  # fills the reader's cache, as an epoch does
    parts = ("read", "augment", "collate")
    res = {m: {"ms": [], **{k: [] for k in parts}} for m in ("library", "plain")}
    for mode in ("library", "plain", "plain", "library", "library", "plain"):
        with _loader_parts(ds, plain=mode == "plain") as acc:
            ms = _loader_pass(ds)
        check(acc["bilinear"] == acc["nearest"] == 2 * len(ms) * TRAIN_BATCH,
              f"{mode}: {acc['bilinear']} bilinear and {acc['nearest']} nearest uint8 "
              f"resizes for {len(ms)} batches of {TRAIN_BATCH} pairs")
        res[mode]["ms"] += ms
        for k in parts:
            res[mode][k].append(acc[k] * 1e3 / len(ms))
    loader = {}
    for mode, r in res.items():
        med = {k: float(np.median(r[k])) for k in ("ms", *parts)}
        med["rest"] = med["ms"] - sum(med[k] for k in parts)
        loader[mode] = med

    def split(m):
        return (f"{m['ms']:.1f} ms a batch = read {m['read']:.1f} + augment "
                f"{m['augment']:.1f} + collate {m['collate']:.1f} + rest {m['rest']:.1f}")
    return {"line": (f"{smi_line}: library built from oryon_tpu_torch/native/ into an empty "
                     f"directory in {build_s:.2f} s; RLE of a 480x640 mask ({len(runs)} runs) "
                     f"and the nearest resize equal the plain versions; bilinear to 224x224 "
                     f"within 1 LSB of the plain version, {diff['view'][0]} of "
                     f"{diff['view'][1]} bytes differ (480x640x3 view), {diff['2-D'][0]} of "
                     f"{diff['2-D'][1]} (480x640 2-D); host ms a call, library / plain: "
                     f"bilinear view {host['lib view']:.3f} / {host['plain view']:.3f}, "
                     f"nearest mask {host['lib mask']:.3f} / {host['plain mask']:.3f}; "
                     f"the loader alone (PrefetchLoader, B={TRAIN_BATCH}, train=True, uint8 "
                     f"RGB cache, {len(ds) // TRAIN_BATCH} batches a pass, {NATIVE_ROUNDS} "
                     f"passes a version in turns, medians): library {split(loader['library'])}"
                     f"; plain {split(loader['plain'])}"),
            "loader": loader, "host": host, "diff": diff}


@phase("train")
def phase_train(torch, tmp, pd_dir, layers, smi_line, tree):
    import run_train_torch
    from oryon_tpu_torch.train import cosine_lr
    name = TRAIN_NAME
    n_pairs, tree_s = tree["pairs"], tree["seconds"]
    steps = n_pairs // TRAIN_BATCH
    valid_batches = -(-len(EVAL_PAIRS) * len(EVAL_CLASSES) // TRAIN_BATCH)
    t0 = time.perf_counter()
    (tr, counts), text = _printed(lambda: _counted(torch, lambda: run_train_torch.main(
        _train_argv(tmp, pd_dir, "training.n_epochs=2"))))
    first_s = time.perf_counter() - t0
    for want in (f"TRAINING on {name}, split {TRAIN_SPLIT}. Samples: {n_pairs}",
                 "augmentations: on-device", "epoch 1: ", "valid epoch 1: ", "saved "):
        check(want in text, f"run_train_torch did not print {want!r}")
    losses = _epoch_losses(text)
    check(sorted(losses) == [0, 1] and all(np.isfinite(v) for e in losses.values()
                                           for v in e.values()), f"epoch lines {losses}")
    want_k1 = layers * (2 * steps + 2 * valid_batches)
    check(tr.state.step == 2 * steps, f"{tr.state.step} steps after 2 epochs")
    check(counts["k1"] == want_k1 and counts["k2"] == 2 * valid_batches
          and sum(counts.values()) == want_k1 + 2 * valid_batches,
          f"2 epochs of {steps} steps + 2 validations: launches {counts}, expected K1 "
          f"{want_k1} and K2 {2 * valid_batches}")
    del tr
    torch.cuda.empty_cache()

    # resume for a third epoch: the step count, the optimizer and the LR go on
    t0 = time.perf_counter()
    (tr, rcounts), text = _printed(lambda: _counted(torch, lambda: run_train_torch.main(
        _train_argv(tmp, pd_dir, "training.n_epochs=3", "resume_ckpt=last"))))
    resume_s = time.perf_counter() - t0
    total = 3 * steps
    check("Resumed from epoch 1" in text and sorted(_epoch_losses(text)) == [2],
          "the resumed run did not continue at epoch 2")
    sched = cosine_lr(1e-3, total, 0.1)
    counts_opt = {st["count"] for st in tr.state.optimizer.state.values()}
    check(tr.state.step == total and counts_opt == {total}
          and tr.state.optimizer.param_groups[0]["lr"] == sched(total - 1),
          f"resumed: step {tr.state.step}, optimizer counts {counts_opt}, LR "
          f"{tr.state.optimizer.param_groups[0]['lr']} (want {total}, {sched(total - 1)})")
    check(rcounts["k1"] == layers * (steps + valid_batches), f"resumed launches {rcounts}")

    # steady steps from one loader, timed in parts; the first one alone
    # launches K1 24 times and nothing else
    torch.cuda.reset_peak_memory_stats()
    sp = _split_steps(torch, tr)
    split, scounts = sp["ms"], sp["counts"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(scounts["k1"] == layers and sum(scounts.values()) == layers,
          f"one train step: launches {scounts}, expected K1 {layers} only")
    last = _epoch_losses(text)[2]
    return {"line": (f"{smi_line}: {n_pairs}-pair ShapeNet6D-format tree (480x640) written "
                     f"in {tree_s:.1f} s; run_train_torch.main at full width (bf16, fused, "
                     f"B={TRAIN_BATCH}, device augs, text cache, validation on the "
                     f"{len(EVAL_PAIRS) * len(EVAL_CLASSES)}-pair REAL275 tree) 2 epochs in "
                     f"{first_s:.1f} s: {2 * steps} steps, launches K1 {counts['k1']} K2 "
                     f"{counts['k2']}; resumed for epoch 3 in {resume_s:.1f} s: step "
                     f"{total}, LR {sched(total - 1):.3e} as the schedule, loss "
                     f"{last['train_loss/total']:.4f}; one step K1 {scounts['k1']}; "
                     f"{sp['steps']} steps through one loader over the tree {TRAIN_REPEATS} "
                     f"times: {sp['pairs_s']:.2f} pairs/s trained steady "
                     f"({sp['whole_pairs_s']:.2f} whole), a step {split['period']:.1f} ms = "
                     f"loader wait {split['wait']:.1f} + host step {split['step']:.1f} "
                     f"(medians past {TRAIN_FILL} fill steps; on the card: augment "
                     f"{split['augment']:.1f}, forward + loss {split['forward']:.1f}, "
                     f"backward {split['backward']:.1f}, optimizer {split['optimizer']:.1f}); "
                     f"peak {peak_gib:.2f} GiB allocated"),
            "split": split, "pairs_s": sp["pairs_s"], "peak_gib": peak_gib}


PD_TRAIN_STEPS = 300                # train_pointdsc at its defaults otherwise
PD_ACC_BOUND = 0.6                  # inlier accuracy over the last 20 steps


@phase("pointdsc_train")
def phase_pointdsc_train(torch, tmp, layers, smi_line):
    """train_pointdsc at its full defaults (6 layers, n=256, batch 8, lr 1e-4)
    for PD_TRAIN_STEPS steps: the BCE falls, the inlier accuracy ends above
    PD_ACC_BOUND; the written native.npz loads through build_pointdsc_solver,
    registers a known rigid pair on the card as on the CPU, and serves one
    batch of 8 at full width through K1 and K2."""
    import copy

    from oryon_tpu_torch.pipeline import build_pointdsc_solver
    from oryon_tpu_torch.scripts import train_pointdsc
    out = os.path.join(tmp, "pd_trained")
    t0 = time.perf_counter()
    run, _ = _printed(lambda: train_pointdsc.main([
        f"steps={PD_TRAIN_STEPS}", "batch=8", "n=256", "lr=1e-4", f"out={out}",
        "--device", DEVICE]))
    train_s = time.perf_counter() - t0
    h = run.history
    bce0, bce1, acc1 = h[:50, 1].mean(), h[-50:, 1].mean(), h[-20:, 3].mean()
    check(np.isfinite(h).all() and bce1 < bce0, f"BCE {bce0:.4f} over the first 50 steps, "
                                                f"{bce1:.4f} over the last 50")
    check(acc1 > PD_ACC_BOUND, f"inlier accuracy {acc1:.3f} over the last 20 steps")
    step_ms = float(np.median(run.step_s[10:])) * 1e3

    pd, text = _printed(lambda: build_pointdsc_solver(out))
    check("flax-native" in text, f"build_pointdsc_solver printed {text!r}")
    A, B, valid, Ts = _rigid_case(torch, np.random.RandomState(13))
    with torch.inference_mode():
        T_card = pd.to(DEVICE)(A, B, valid)[0].cpu().numpy()
        T_cpu = copy.deepcopy(pd).cpu()(A.cpu(), B.cpu(), valid.cpu())[0].numpy()
    dev_err = _pose_err(T_card, T_cpu.astype(np.float64))
    gt_err = _pose_err(T_card, Ts)
    check(dev_err[0] < ROT_TOL and dev_err[1] < TRANS_TOL,
          f"trained PointDSC: the card's poses {dev_err[0]:.2e} rad, {dev_err[1]:.2e} m from "
          f"the CPU's")
    check(gt_err[0] < ROT_TOL and gt_err[1] < TRANS_TOL,
          f"trained PointDSC: {gt_err[0]:.2e} rad, {gt_err[1]:.2e} m from the known transform")

    model, _ = _serving_model(torch)
    pred = _predictor(model, pd)
    reqs = _requests(np.random.RandomState(14), 8, ["mug", "box", "bottle"])
    results, counts = _counted(torch, lambda: pred.predict(reqs))
    n_det = _check_results(results, reqs)
    check(counts["k1"] == layers and counts["k2"] == 1 and sum(counts.values()) == layers + 1,
          f"a served batch with the trained PointDSC: launches {counts}")
    del pred, model
    return {"line": (f"{smi_line}: train_pointdsc {PD_TRAIN_STEPS} steps (6 layers, n=256, "
                     f"B=8) in {train_s:.1f} s, median step {step_ms:.2f} ms; BCE "
                     f"{bce0:.4f} -> {bce1:.4f} (first / last 50 steps), inlier accuracy "
                     f"{acc1:.3f} (last 20); held-out 16 problems: R err mean "
                     f"{run.r_errs.mean():.3f} deg (median {np.median(run.r_errs):.3f}), T err "
                     f"mean {run.t_errs.mean():.3f} cm; native.npz through "
                     f"build_pointdsc_solver: card vs CPU {dev_err[0]:.1e} rad / "
                     f"{dev_err[1]:.1e} m, vs the known transform {gt_err[0]:.1e} rad / "
                     f"{gt_err[1]:.1e} m; a served batch of 8 with it: K1 {counts['k1']} K2 "
                     f"{counts['k2']}, {n_det} detections"),
            "pd_dir": out, "step_ms": step_ms}


def _split_nn(root, key, device):
    """make_pair_split's nearest-neighbour search of one written pair:
    (warped anchor points, query points, nearest index, distance mm)."""
    from oryon_tpu_torch.data.datasets import NocsReader
    from oryon_tpu_torch.scripts import make_pair_split as mps
    sa, ia, sq, iq, _, obj = key.split("_", 5)
    reader = NocsReader(root)
    item_a, item_q = reader.get_item(int(sa), int(ia), obj), reader.get_item(int(sq), int(iq), obj)
    rel = np.asarray(item_q["pose"], np.float64) @ np.linalg.inv(
        np.asarray(item_a["pose"], np.float64))
    rel[:3, 3] *= 1000.0
    warped, _, pq, _, _ = mps.subsampled(*mps.lift_masked(item_a), *mps.lift_masked(item_q), rel)
    return (warped, pq, *mps.nearest(warped, pq, device))


def _check_split(root, card, cpu) -> dict:
    """The card's split against the CPU's: instance lists byte-equal, poses
    exact, and the matches equal except where the two devices' f32 distance
    expansions (a^2 - 2ab + b^2 in mm, coordinates near 700 mm) round
    differently: each device's nearest neighbour must then be nearest in
    f64 up to that rounding, and a match may flip only where the f64
    distance lies within it of the 2 mm threshold."""
    with open(os.path.join(card.out_dir, "instance_list.txt"), "rb") as a, \
            open(os.path.join(cpu.out_dir, "instance_list.txt"), "rb") as b:
        check(a.read() == b.read(), "instance_list.txt differs between the card and the CPU")
    check(card.annots.keys() == cpu.annots.keys(), "the pairs differ")
    differ, rows, eps_max = 0, 0, 0.0
    for key, want in cpu.annots.items():
        got = card.annots[key]
        check(np.array_equal(got["gt"], want["gt"]), f"{key}: gt differs")
        if np.array_equal(got["corrs"], want["corrs"]):
            continue
        differ += 1
        warped, pq, i_card, d_card = _split_nn(root, key, DEVICE)
        i_cpu, d_cpu = _split_nn(root, key, "cpu")[2:]
        good_card, good_cpu = d_card < 2.0, d_cpu < 2.0
        odd = np.nonzero((good_card != good_cpu) | ((i_card != i_cpu) & good_card & good_cpu))[0]
        d2 = ((warped[odd, None, :] - pq[None]) ** 2).sum(-1)             # f64
        best = d2.min(1)
        # the rounding of the f32 expansion: a few ulps of (|a| + |b|)^2
        eps = 2.0 ** -21 * (np.linalg.norm(warped[odd], axis=1)
                            + np.linalg.norm(pq, axis=1).max()) ** 2
        r = np.arange(len(odd))
        check(np.all(d2[r, i_card[odd]] - best <= eps) and np.all(d2[r, i_cpu[odd]] - best <= eps),
              f"{key}: a device's nearest neighbour is not nearest in f64")
        flip = good_card[odd] != good_cpu[odd]
        check(np.all(np.abs(best[flip] - 4.0) <= eps[flip]),
              f"{key}: a match flips away from the 2 mm threshold")
        rows += len(odd)
        eps_max = max(eps_max, float(eps.max()))
    return {"pairs": len(cpu.annots), "differ": differ, "rows": rows, "eps_mm2": eps_max}


FUSION_ABLATIONS = (("full attention", dict(attention_type="full")),
                    ("mlp head", dict(guidance_head="mlp")),
                    ("no head", dict(guidance_head="none")),
                    ("no appearance guidance", dict(use_appearance_guidance=False)))
FUSION_COS_BOUND = 0.999


def _fusion_ablations(torch) -> dict:
    """Each ablation of the fusion at full width (B=16 images) on the card
    in bf16 against its f32 CPU run on the same inputs and weights: the
    smallest per-image cosine."""
    import dataclasses

    from oryon_tpu_torch.models.fusion import FusionConfig, ImageTextFusion
    from oryon_tpu_torch.models.layers import random_init_
    rs = np.random.RandomState(15)
    c = FusionConfig()
    x = [rs.randn(16, 24, 24, c.clip_dim), rs.randn(16, c.num_prompts, c.text_guidance_dim),
         rs.randn(16, 24, 24, c.appearance_guidance_dim)]
    x = [torch.tensor(a, dtype=torch.float32) for a in x]
    out = {}
    for name, kw in FUSION_ABLATIONS:
        cfg = dataclasses.replace(c, **kw)
        card = random_init_(ImageTextFusion(cfg), torch.Generator().manual_seed(16))
        ref = ImageTextFusion(cfg, dtype=torch.float32)
        ref.load_state_dict(card.state_dict())
        with torch.inference_mode():
            got = card.to(DEVICE)(*(a.to(DEVICE) for a in x)).float().cpu()
            want = ref(*x)
        out[name] = _min_cosine(torch, [got], [want])
        check(out[name] > FUSION_COS_BOUND, f"fusion ({name}): cosine {out[name]:.6f} on the "
                                            f"card against the f32 CPU run")
    return out


@phase("tools")
def phase_tools(torch, tmp, pd_dir, layers, smi_line, eval_res):
    """The offline tools over the eval and train phases' trees and
    checkpoints: make_pair_split on the card against the CPU;
    compute_metrics on the eval phase's CSV; null_baselines; the checkpoint
    sweep of the train phase's epochs (K1 / K2 launches per epoch, its last
    row against run_test_torch on that checkpoint); the hyper-parameter
    sweep; the fusion ablations against their f32 CPU runs."""
    import run_test_torch
    from oryon_tpu_torch.scripts import (compute_metrics, make_pair_split, null_baselines,
                                         sweep_checkpoints, sweep_eval_hparams)
    name = "nocs_smoke"
    root = os.path.join(tmp, name)
    times = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out, _ = _printed(fn)
        times[key] = time.perf_counter() - t0
        return out

    split = [f"dataset.root={tmp}", f"dataset.test.name={name}", "n_pairs=16", "pair_mode=any"]
    card = timed("split", lambda: make_pair_split.main(split + ["split_name=made_card",
                                                                "--device", DEVICE]))
    cpu = timed("split_cpu", lambda: make_pair_split.main(split + ["split_name=made_cpu",
                                                                   "--device", "cpu"]))
    check(len(card.lines) == 16, f"make_pair_split wrote {len(card.lines)} pairs")
    sp = _check_split(root, card, cpu)

    base = [a for a in _eval_overrides(tmp, pd_dir, name)
            if not a.startswith(("eval.ckpt=", "exp_name=", "compute_vsd="))]
    ev = timed("metrics", lambda: compute_metrics.main(
        [eval_res["csv"], *base, "compute_vsd=false", "--device", DEVICE]))
    got, want = ev.get_means(), eval_res["means"]
    keys = [k for k in got if k in want]
    errs = {k: abs(got[k] - want[k]) for k in keys}
    # the recomputed absolute pose is the CSV's relative pose times the
    # anchor pose in numpy, the eval phase's came from the card: the angle
    # and the offset may differ in the last f32 digits
    check(len(keys) >= 10 and all(errs[k] < 1e-6 for k in keys if k not in ("R error", "T error"))
          and errs["R error"] < 1e-5 and errs["T error"] < 1e-5,
          f"compute_metrics against the eval phase: {errs}")

    nb = timed("null", lambda: null_baselines.main(base + ["compute_vsd=true", "--device",
                                                           DEVICE]))
    gt = nb["gt"]
    check(gt["ADD(S)-0.1d"] == gt["MSSD"] == gt["MSPD"] == gt["VSD"] == 1.0,
          f"null_baselines gt: {gt}")

    sweep_args = base + ["exp_name=train_smoke", "compute_vsd=true", "--device", DEVICE]
    ck = timed("ckpt_sweep", lambda: sweep_checkpoints.main(sweep_args))
    epochs = [r["epoch"] for r in ck.rows]
    check(epochs == [0, 1, 2], f"sweep_checkpoints epochs {epochs}")
    for e, c in zip(epochs, ck.launches):
        check(c["k1"] == 2 * layers and c["k2"] == 2 and sum(c.values()) == 2 * layers + 2,
              f"sweep_checkpoints epoch {e}: launches {c}")
    rt = timed("run_test", lambda: run_test_torch.main(sweep_args[:-2] + [
        "eval.ckpt=2", "--device", DEVICE]))
    single = rt.evaluator.get_means()
    last = ck.rows[-1]
    row_err = max(abs(last[k] - single[k]) for k in single)
    check(set(single) <= set(last) and row_err < 1e-6,
          f"the sweep's last row is {row_err:.2e} from run_test_torch on that checkpoint")

    hp = timed("hparams", lambda: sweep_eval_hparams.main(
        sweep_args + ["eval.ckpt=last", "--variants=;test.solver=ransac"]))
    check([r["variant"] for r in hp.rows] == ["default", "test.solver=ransac"] and hp.epoch == 2,
          f"sweep_eval_hparams rows {[r['variant'] for r in hp.rows]}, epoch {hp.epoch}")
    for c in hp.launches:
        check(c["k1"] == 2 * layers and c["k2"] == 2, f"sweep_eval_hparams launches {c}")

    t0 = time.perf_counter()
    fusion = _fusion_ablations(torch)
    times["fusion"] = time.perf_counter() - t0
    sweep_txt = "; ".join(f"epoch {e}: {s:.1f} s, K1 {c['k1']} K2 {c['k2']}, AR {r['AR']:.3f}"
                          for e, s, c, r in zip(epochs, ck.seconds, ck.launches, ck.rows))
    return {"line": (f"{smi_line}: make_pair_split (16 pairs) {times['split']:.1f} s on the "
                     f"card, {times['split_cpu']:.1f} s on the CPU, instance lists byte-equal, "
                     f"gt exact, {sp['differ']} of {sp['pairs']} pairs' matches differ ({sp['rows']} "
                     f"rows, each within the f32 expansion's rounding, at most "
                     f"{sp['eps_mm2']:.2f} mm^2, of a tie or the threshold); compute_metrics on the "
                     f"eval CSV {times['metrics']:.1f} s: {len(keys)} metrics, largest "
                     f"difference {max(errs.values()):.2e} (R error {errs['R error']:.2e} deg, "
                     f"T error {errs['T error']:.2e} cm); null_baselines {times['null']:.1f} s: "
                     f"gt recall 1, identity ADD(S) {nb['identity']['ADD(S)-0.1d']:.3f}; "
                     f"sweep_checkpoints {times['ckpt_sweep']:.1f} s ({sweep_txt}), its last "
                     f"row {row_err:.1e} from run_test_torch ({times['run_test']:.1f} s); "
                     f"sweep_eval_hparams {times['hparams']:.1f} s: "
                     + ", ".join(f"{r['variant']} {s:.1f} s AR {r['AR']:.3f}"
                                 for r, s in zip(hp.rows, hp.seconds))
                     + f"; fusion ablations in {times['fusion']:.1f} s, cosine vs f32 CPU: "
                     + ", ".join(f"{k} {v:.6f}" for k, v in fusion.items())),
            "times": times}


def _full_train_model(torch, seed: int, train_towers: bool = False):
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import full_oryon
    model = random_init_(full_oryon(train_towers=train_towers),
                         torch.Generator().manual_seed(seed))
    return model.to(DEVICE)


def _synthetic_train_batch(torch, model, B: int, seed: int):
    """A synthetic full-width batch with its prompt embeddings cached."""
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.pipeline import make_train_text_cache
    batch = synthetic_pair_batch(seed=seed, batch=B, n_prompts=model.fusion_cfg.num_prompts,
                                 device=DEVICE)
    return batch._replace(text_emb=make_train_text_cache(model)(batch.prompt_ids),
                          prompt_ids=None)


@phase("overfit")
def phase_overfit(torch):
    """Ten steps on one fixed batch with the same draws each step: the
    loss must fall."""
    from oryon_tpu_torch.train import create_train_state, make_train_step
    model = _full_train_model(torch, 11)
    batch = _synthetic_train_batch(torch, model, OVERFIT_BATCH, 3)
    state, step = create_train_state(model, total_steps=OVERFIT_STEPS), make_train_step()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OVERFIT_STEPS):
        _, m = step(state, batch, torch.Generator(device=DEVICE).manual_seed(0))
        losses.append(m["loss/total"])
    losses = [float(v) for v in losses]
    step_ms = (time.perf_counter() - t0) / OVERFIT_STEPS * 1e3
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"losses {losses}")
    return {"line": (f"full width, B={OVERFIT_BATCH}, {OVERFIT_STEPS} AdamW steps on one "
                     f"batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}, mask "
                     f"{float(m['loss/mask']):.4f}, IoU {float(m['metric/iou_a']):.3f}, "
                     f"{step_ms:.1f} ms a step")}


def _fd_grad(model):
    """The fusion and decoder gradient as one f32 vector."""
    import torch
    return torch.cat([p.grad.float().flatten() for n, p in model.named_parameters()
                      if n.split(".")[0] in ("fusion", "decoder")])


K1_BWD_MASKED = (16, K1_PADDED, 3 * 1024)   # the padded tower's qkv, keys >= 577 masked
K1_BWD_TOL, K1_BWD_COS = 2e-2, 0.9999   # bf16: of the largest |plain| value; cosine


def _bwd_gate(torch, got, ref, what: str, f32: bool = False) -> float:
    """K1's backward against its plain version: bf16 max abs error within
    K1_BWD_TOL of the largest |plain| value and cosine >= K1_BWD_COS (both
    round S, P, dP and dS * scale to bf16, in other orders of summation);
    f32 within K1_F32_TOL of it (at least 1).  Returns the max abs error."""
    torch.cuda.synchronize()
    g, r = got.float().flatten(), ref.float().flatten()
    check(bool(torch.isfinite(g).all()), f"{what}: kernel output not finite")
    err, top = (g - r).abs().max().item(), r.abs().max().item()
    if f32:
        check(err <= K1_F32_TOL * max(1.0, top), f"{what}: max abs err {err} (largest {top})")
        return err
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item() if top > 0 else 1.0
    check(err <= K1_BWD_TOL * top and cos >= K1_BWD_COS,
          f"{what}: max abs err {err} (largest {top}), cosine {cos:.6f}")
    return err


def _peak_gib(torch, fn) -> float:
    """Device memory fn() allocates beyond what was allocated before, at its
    peak, in GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _k1_bwd_train(torch, mha_lanes, iters):
    """K1's backward at the training shape (no key masked; kmask has no
    gradient in the tower): the kernel through autograd against the plain
    backward, two launches bitwise equal, d kmask as well; timed beside the
    plain version and SDPA's backward, with its bound and peak memory; the
    query-tile and key-tile kernels are timed alone (``split_ms``)."""
    B, L, C3 = K1_TRAIN_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(4)
    qkv = torch.randn((B, L, C3), generator=g, device=DEVICE).to(torch.bfloat16).requires_grad_()
    kmask = torch.zeros(L, device=DEVICE)
    dout = torch.randn((B, L, C3 // 3), generator=g, device=DEVICE).to(torch.bfloat16)
    scale = (C3 // 3 // K1_HEADS) ** -0.5
    out = mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale)
    res = {"fwd_err": compare(torch, out, mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale),
                              "K1's autograd.Function forward at the training shape")}

    def kernel():
        return torch.autograd.grad(out, qkv, dout, retain_graph=True)[0]

    def plain(want_mask=False):
        return mha_lanes.reference_mha_backward(qkv, kmask, dout, K1_HEADS, scale, want_mask)
    before = mha_lanes.launches_bwd
    got = kernel()
    check(mha_lanes.launches_bwd == before + 1, "K1's backward kernel did not launch")
    ref, ref_m = plain(True)
    res["err"] = _bwd_gate(torch, got, ref, "K1 backward at the training shape")
    same_twice(torch, kernel, "K1 backward")
    dq, dm = mha_lanes._backward(qkv.detach(), kmask, dout, K1_HEADS, scale, True)
    check(bool(torch.equal(dq, got)), "K1 backward: d qkv moved when d kmask was asked for")
    res["mask_err"] = _bwd_gate(torch, dm, ref_m, "K1 backward's d kmask at the training shape")

    def body(entry, phases=mha_lanes.BWD_DQ | mha_lanes.BWD_DKV, stats=None):
        return lambda: mha_lanes.run_backward_entry(entry, qkv.detach(), kmask, dout, K1_HEADS,
                                                    scale, False, phases, stats)[0]
    check(bool(torch.equal(body(mha_lanes.BWD_WGMMA)(), got)),
          "K1 backward: the entry moved d qkv")
    del ref, ref_m, dq, dm
    lib = sdpa_packed(torch, qkv, None, K1_HEADS)
    res.update(timed(kernel, plain,
                     lambda: torch.autograd.grad(lib, qkv, dout, retain_graph=True), iters))
    # the key-tile kernel alone reads the row statistics the query-tile kernel
    # wrote into one scratch, which both then keep using
    stats = mha_lanes.backward_stats(qkv, K1_HEADS)
    split = {"dq": body(mha_lanes.BWD_WGMMA, mha_lanes.BWD_DQ, stats),
             "dkv": body(mha_lanes.BWD_WGMMA, mha_lanes.BWD_DKV, stats)}
    C = C3 // 3
    check(bool(torch.equal(split["dq"]()[..., :C], got[..., :C])),
          "K1 backward: the query-tile kernel alone moved d q")
    check(bool(torch.equal(split["dkv"]()[..., C:], got[..., C:])),
          "K1 backward: the key-tile kernel alone moved d k, d v")
    res["split_ms"] = in_turns(split, iters)
    res["peak_gib"], res["plain_peak_gib"] = _peak_gib(torch, kernel), _peak_gib(torch, plain)
    hd = C3 // 3 // K1_HEADS
    # five L x L x hd products: S, dP, dV, dQ, dK
    res.update(bound(nbytes(qkv, kmask, dout, got), {"bf16": 10 * B * K1_HEADS * L * L * hd}))
    return res


def _k1_bwd_masked(torch, mha_lanes):
    """K1's backward through autograd at the padded tower's shape, keys >= 577
    masked, d qkv and d kmask, with qk_int8 off and on (straight-through: the
    same gradient, bitwise).  Returns the max abs error."""
    B, L, C3 = K1_BWD_MASKED
    g = torch.Generator(device=DEVICE).manual_seed(5)
    qkv = torch.randn((B, L, C3), generator=g, device=DEVICE).to(torch.bfloat16).requires_grad_()
    kmask = torch.where(torch.arange(L, device=DEVICE) < K1_SHAPE[1], 0.0, -1e9).requires_grad_()
    dout = torch.randn((B, L, C3 // 3), generator=g, device=DEVICE).to(torch.bfloat16)
    scale = (C3 // 3 // K1_HEADS) ** -0.5
    ref = mha_lanes.reference_mha(qkv, kmask, K1_HEADS, scale)
    ref_q, ref_m = torch.autograd.grad(ref, (qkv, kmask), dout)
    grads, err = [], 0.0
    for i8 in (False, True):
        before = mha_lanes.launches_bwd
        out = mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale, qk_int8=i8)
        grads.append(torch.autograd.grad(out, (qkv, kmask), dout))
        check(mha_lanes.launches_bwd == before + 1, f"qk_int8={i8}: no backward launch")
        err = max(err, _bwd_gate(torch, grads[-1][0], ref_q, f"K1 backward, qk_int8={i8}"),
                  _bwd_gate(torch, grads[-1][1], ref_m, f"K1 backward's d kmask, qk_int8={i8}"))
    check(all(bool(torch.equal(a, b)) for a, b in zip(*grads)),
          "K1 backward: qk_int8 changed the gradient")
    return err


def _k1_bwd_other_hd(torch, mha_lanes):
    """K1's backward through autograd at K1_OTHER_HD, which the route sends
    to the mma.sync body: d qkv and d kmask against the plain version, one
    launch counted, two launches bitwise equal.  Returns the max abs error."""
    name, B, L, hd, real, _ = K1_OTHER_HD
    check(mha_lanes.backward_entry(hd) == "oryon_mha_lanes_bwd_bf16",
          f"K1 backward {name}: routed to {mha_lanes.backward_entry(hd)}")
    g = torch.Generator(device=DEVICE).manual_seed(8)
    qkv = torch.randn((B, L, 3 * K1_HEADS * hd), generator=g,
                      device=DEVICE).to(torch.bfloat16).requires_grad_()
    kmask = torch.where(torch.arange(L, device=DEVICE) < real, 0.0, -1e9).requires_grad_()
    dout = torch.randn((B, L, K1_HEADS * hd), generator=g, device=DEVICE).to(torch.bfloat16)
    scale = hd ** -0.5
    out = mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_HEADS, scale)

    def grad():
        return torch.autograd.grad(out, (qkv, kmask), dout, retain_graph=True)
    before = mha_lanes.launches_bwd
    got_q, got_m = grad()
    check(mha_lanes.launches_bwd == before + 1, f"K1 backward {name}: no launch counted")
    ref_q, ref_m = mha_lanes.reference_mha_backward(qkv, kmask, dout, K1_HEADS, scale, True)
    err = max(_bwd_gate(torch, got_q, ref_q, f"K1 backward {name}"),
              _bwd_gate(torch, got_m, ref_m, f"K1 backward's d kmask {name}"))
    same_twice(torch, lambda: torch.cat([t.float().flatten() for t in grad()]),
               f"K1 backward {name}")
    return err


def _k1_bwd_f32(torch, mha_lanes, iters):
    """K1's backward in f32 at the towers' path shapes and at K1_F32_EDGES,
    the body the route gives: d qkv through autograd and d kmask against the
    plain version within K1_F32_TOL (32 keys masked where L > 64), d qkv the
    same with and without d kmask, two launches bitwise equal (d kmask too),
    the kernels a call without and with d kmask (``graph_kernels``).  Per
    path shape: the device ms of a call with the launch queue kept full, its
    host us, the ms of a gradient through autograd; SDPA's f32 backward with
    the queue full, the plain version, the bound.  Returns (max error,
    {shape: timings})."""
    g = torch.Generator(device=DEVICE).manual_seed(6)
    err, res = 0.0, {}
    for shape in K1_F32_PATHS + K1_F32_EDGES:
        B, L, C3 = shape
        qkv, kmask, dout = _f32_inputs(torch, g, shape, grad=True)
        if L > 64:
            kmask[-32:] = -1e9
        scale = (C3 // 3 // K1_F32_HEADS) ** -0.5
        out = mha_lanes.fused_mha_lanes_qkv(qkv, kmask, K1_F32_HEADS, scale)
        ref, ref_m = mha_lanes.reference_mha_backward(qkv, kmask, dout, K1_F32_HEADS, scale,
                                                      True)

        def call(want_mask=False):
            return mha_lanes._backward(qkv.detach(), kmask, dout, K1_F32_HEADS, scale,
                                       want_mask)

        def grad():
            return torch.autograd.grad(out, qkv, dout, retain_graph=True)[0]
        what = f"K1 f32 backward, {list(shape)}"
        before = mha_lanes.launches_bwd
        got = grad()
        check(mha_lanes.launches_bwd == before + 1, f"{what}: no launch counted")
        dq, dm = call(True)
        check(bool(torch.equal(dq, got)), f"{what}: d qkv moved with d kmask")
        same_twice(torch, lambda: torch.cat([t.flatten() for t in call(True)]), what)
        kernels = tuple(graph_kernels(torch, lambda: call(w)) for w in (False, True))
        err = max(err, _bwd_gate(torch, got, ref, what, f32=True),
                  _bwd_gate(torch, dm, ref_m, f"{what}: d kmask", f32=True))
        if shape not in K1_F32_PATHS:
            continue
        lib = sdpa_packed(torch, qkv, None, K1_F32_HEADS)
        r = {"ms": queued_ms(call, iters), "host_us": host_us(call),
             "grad_ms": cuda_ms(grad, iters), "kernels": kernels,
             "plain_ms": cuda_ms(lambda: mha_lanes.reference_mha_backward(
                 qkv, kmask, dout, K1_F32_HEADS, scale, False), iters),
             "library_ms": queued_ms(
                 lambda: torch.autograd.grad(lib, qkv, dout, retain_graph=True), iters)}
        # five L x L x hd products a head: S, dP, dV, dQ, dK
        r.update(bound(nbytes(qkv, kmask, dout, got), {"f32": 10 * B * L * L * (C3 // 3)}))
        res[str(list(shape))] = r
    return err, res


@phase("train_towers")
def phase_train_towers(torch, iters, layers):
    from oryon_tpu_torch.ops.cuda import mha_lanes
    from oryon_tpu_torch.train import create_train_state, loss_and_metrics, make_train_step
    model = _full_train_model(torch, 13, train_towers=True)
    batch = _synthetic_train_batch(torch, model, TRAIN_BATCH, 5)
    state, step = create_train_state(model), make_train_step()
    torch.cuda.reset_peak_memory_stats()
    step_counts, step_ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        (_, m), c = _counted(torch, lambda: step(state, batch, torch.Generator(
            device=DEVICE).manual_seed(1)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_counts.append(c)
        check(np.isfinite(float(m["loss/total"])), "train_towers: loss not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for c in step_counts:
        check(c["k1"] == 2 * layers and c["k1bwd"] == layers and sum(c.values()) == 3 * layers,
              f"train_towers step launches {c}, expected K1 {layers} + {layers} (recomputed) "
              f"and K1's backward {layers}")
    grads = {t: [p.grad for n, p in model.named_parameters() if n.startswith(t + ".")]
             for t in ("vlm_visual", "guidance", "vlm_text")}
    check(all(g is None for g in grads["vlm_text"]), "a gradient reached the text tower")
    for t in ("vlm_visual", "guidance"):
        check(any(g is not None and bool(g.abs().max() > 0) for g in grads[t]),
              f"no gradient reached {t}")

    # the same step's loss and fusion/decoder gradient with the plain tower
    def loss_grad():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_and_metrics(model, state.loss_cfg, batch,
                                   torch.Generator(device=DEVICE).manual_seed(2))
        loss.backward()
        return float(loss), _fd_grad(model)
    loss_k, g_k = loss_grad()
    _set_attn(model, "einsum", "einsum")
    loss_p, g_p = loss_grad()
    cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(cos > GRAD_COS_BOUND and rel < GRAD_LOSS_TOL,
          f"fused vs einsum tower: gradient cosine {cos:.6f}, loss {loss_k} vs {loss_p}")
    _set_attn(model, "flash", "einsum")
    model.zero_grad(set_to_none=True)
    loss, _ = loss_and_metrics(model, state.loss_cfg, batch, torch.Generator(device=DEVICE))
    try:
        loss.backward()
        raised = "nothing"
    except RuntimeError as e:
        raised = str(e)
    check("cannot be differentiated" in raised,
          f"attn_impl=flash under train_towers: backward raised {raised}")
    del loss, model, state, batch, g_k, g_p
    torch.cuda.empty_cache()

    res = _k1_bwd_train(torch, mha_lanes, iters)
    masked_err = _k1_bwd_masked(torch, mha_lanes)
    other_err = _k1_bwd_other_hd(torch, mha_lanes)
    res.update(peak_step_gib=peak_gib, step_ms=step_ms, launches=step_counts[0]["k1bwd"])
    res["line"] = (f"full width, B={TRAIN_BATCH}, Swin einsum, K1 fused: 2 steps "
                   f"({', '.join(f'{v:.0f}' for v in step_ms)} ms host) with launches "
                   f"K1 {step_counts[0]['k1']} a step ({layers} + {layers} recomputed) and "
                   f"K1's backward {step_counts[0]['k1bwd']}, gradients in vlm_visual and "
                   f"guidance, none in vlm_text; peak {peak_gib:.2f} GiB allocated; "
                   f"fusion/decoder gradient vs the einsum tower: cosine {cos:.6f} (bound "
                   f"{GRAD_COS_BOUND}), loss {loss_k:.5f} vs {loss_p:.5f} (rel {rel:.2e}, tol "
                   f"{GRAD_LOSS_TOL}); attn_impl=flash raises; K1 at qkv {list(K1_TRAIN_SHAPE)} "
                   f"bf16 under autograd: forward max abs err {res['fwd_err']:.3e} (tol "
                   f"{KERNEL_TOL}), backward kernel vs plain max abs err {res['err']:.3e}, d "
                   f"kmask {res['mask_err']:.3e} (tol {K1_BWD_TOL} of the largest value, "
                   f"cosine >= {K1_BWD_COS}), two launches bitwise equal, {times_txt(res)}, "
                   f"kernel / library {res['ms'] / res['library_ms']:.2f}; alone: "
                   + ", ".join(f"{k} {v:.4f} ms" for k, v in res["split_ms"].items())
                   + f"; peak "
                   f"{res['peak_gib']:.3f} GiB (plain {res['plain_peak_gib']:.2f}); "
                   f"{list(K1_BWD_MASKED)}, keys >= {K1_SHAPE[1]} masked, qk_int8 off and on "
                   f"(the same gradient bitwise): max abs err {masked_err:.3e}; "
                   f"{K1_OTHER_HD[0]} on the mma.sync body: max abs err {other_err:.3e} (f32: "
                   f"train_towers_small)")
    return res


@phase("train_towers_small")
def phase_train_towers_small(torch, iters):
    """The small model (f32 towers, 4 heads of 16) trained with its towers
    at B=32 through train.make_train_step: K1's f32 mode and its backward on
    the one-block-a-head kernels, each one CUDA kernel a launch (the
    profiler's count); the loss finite; the tower and fusion/decoder
    gradients against the einsum tower's; the step's device ms.  Then K1's
    f32 backward at the path shapes (``_k1_bwd_f32``)."""
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import small_oryon
    from oryon_tpu_torch.ops.cuda import mha_lanes
    from oryon_tpu_torch.train import create_train_state, loss_and_metrics, make_train_step
    model = random_init_(small_oryon(train_towers=True),
                         torch.Generator().manual_seed(17)).to(DEVICE)
    batch = _synthetic_train_batch(torch, model, TRAIN_BATCH, 7)
    state, step = create_train_state(model), make_train_step()
    layers = model.vision_cfg.layers

    def run_step():
        return step(state, batch, torch.Generator(device=DEVICE).manual_seed(1))
    run_step()
    (_, m), counts = _counted(torch, run_step)
    check(np.isfinite(float(m["loss/total"])), "train_towers_small: loss not finite")
    check(counts["k1"] == 2 * layers and counts["k1bwd"] == layers
          and sum(counts.values()) == 3 * layers,
          f"small train_towers step launches {counts}, expected K1 {layers} + {layers} "
          f"(recomputed) and K1's backward {layers}")
    want = {K1_F32_HEAD_KERNELS[0]: 2 * layers, K1_F32_HEAD_KERNELS[1]: layers}
    names = device_kernels(torch, run_step, lambda n: {
        k: kernels_named(n, (k,)) for k in K1_F32_HEAD_KERNELS} == want)
    seen = {k: kernels_named(names, (k,)) for k in K1_F32_HEAD_KERNELS}
    old = kernels_named(names, K1_F32_OLD_KERNELS)
    check(seen == want and old == 0,
          f"small train_towers step ran {seen} and {old} of the former bodies' kernels")

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_and_metrics(model, state.loss_cfg, batch,
                                   torch.Generator(device=DEVICE).manual_seed(2))
        loss.backward()
        tower = torch.cat([p.grad.flatten() for n, p in model.named_parameters()
                           if n.startswith("vlm_visual.") and p.grad is not None])
        return loss.item(), _fd_grad(model), tower
    loss_k, fd_k, tw_k = grads()
    _set_attn(model, "einsum", "einsum")
    loss_p, fd_p, tw_p = grads()
    _set_attn(model, "fused", "einsum")
    cos = {k: torch.nn.functional.cosine_similarity(a, b, dim=0).item()
           for k, a, b in (("tower", tw_k, tw_p), ("fusion/decoder", fd_k, fd_p))}
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(min(cos.values()) > GRAD_COS_BOUND and rel < GRAD_LOSS_TOL,
          f"K1 f32 vs einsum tower: gradient cosines {cos}, loss {loss_k} vs {loss_p}")
    model.zero_grad(set_to_none=True)
    step_ms = cuda_ms(run_step, iters)
    del model, state, batch
    torch.cuda.empty_cache()
    err, times = _k1_bwd_f32(torch, mha_lanes, iters)
    shape = str(list(K1_F32_PATHS[2]))   # the step's own
    return {"line": (
        f"small model, B={TRAIN_BATCH}, towers trained: launches K1 {counts['k1']} a step "
        f"({layers} + {layers} recomputed) and K1's backward {counts['k1bwd']}, each one "
        f"kernel ({seen}; the former bodies' kernels 0); loss {float(m['loss/total']):.5f}; "
        f"gradient vs the einsum tower: cosine "
        + ", ".join(f"{k} {v:.7f}" for k, v in cos.items())
        + f" (bound {GRAD_COS_BOUND}), loss rel {rel:.2e}; device {step_ms:.3f} ms a step"
        + f"; K1's f32 backward at " + ", ".join(str(list(s_)) for s_ in
                                                 K1_F32_PATHS + K1_F32_EDGES)
        + f": max abs err {err:.2e} (tol {K1_F32_TOL} of the largest value); "
        + _f32_times_txt(times)),
        "counts": counts, "step_ms": step_ms,
        "k1bwdf32": dict(times[shape], err=err)}


# ---- several GPUs: mesh1 (NCCL, one rank), dp2 and tp2 (gloo, two ranks on
# the one card; they say nothing of scaling: the ranks share the card)
MESH1_STEPS = 3                   # timed steps per turn, plain / mesh / mesh / plain
DP2_STEPS = 3
MP2_TIMEOUT = 480                 # seconds for both two-rank phases


def _train_defaults(torch, model):
    """(train state, augmentation, accum_steps) of run_train.py's defaults on
    ``model`` (fresh optimizer)."""
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.device_augment import DeviceAugConfig
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig
    from oryon_tpu_torch.train import create_train_state
    cfg = load_config(None, [])
    o, lo, rgb = cfg.optimization, cfg.loss, cfg.augs.rgb
    state = create_train_state(
        model, lr=o.lr, weight_decay=o.w_decay, total_steps=1000, gamma=o.gamma,
        loss_cfg=FeatureLossConfig(pos_margin=lo.pos_margin, neg_margin=lo.neg_margin,
                                   neg_kernel=lo.neg_kernel_size, neg_pool=lo.neg_pool,
                                   hard_negatives=lo.hard_negatives, mask_type=lo.mask_type,
                                   mask_threshold=cfg.test.mask_threshold, w_mask=lo.w.mask,
                                   w_pos=lo.w.pos, w_neg=lo.w.neg),
        optim_type=o.optim_type, scheduler_type=o.scheduler_type, momentum=o.momentum)
    aug = DeviceAugConfig(jitter=rgb.jitter, bright=rgb.bright, hflip=rgb.hflip,
                          vflip=rgb.vflip) if rgb.device else None
    return state, aug, cfg.training.accum_steps


def _train_batches(torch, model, B: int, seeds):
    """Synthetic full-width batches of B with their prompt embeddings."""
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.pipeline import make_train_text_cache
    cache, out = make_train_text_cache(model), []
    for seed in seeds:
        b = synthetic_pair_batch(seed=seed, batch=B, n_prompts=model.fusion_cfg.num_prompts,
                                 device=DEVICE)
        out.append(b._replace(text_emb=cache(b.prompt_ids), prompt_ids=None))
    return out


def _trainable(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.split(".")[0] in ("fusion", "decoder")}


def _reset(model, weights):
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in weights:
                p.copy_(weights[n])


def _steps(torch, model, init, batches, mesh=None, rows=None):
    """Train from ``init`` (fusion and decoder weights) over ``batches`` with
    run_train.py's defaults, the draws from a generator seeded 0: (losses,
    the first step's fusion/decoder gradient on the host, seconds a step).
    ``mesh``: each rank steps on its rows of every batch."""
    from oryon_tpu_torch.parallel.mesh import shard_batch
    from oryon_tpu_torch.train import make_train_step
    _reset(model, init)
    state, aug, accum = _train_defaults(torch, model)
    step = make_train_step(aug, accum, mesh)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    losses, secs, grad = [], [], None
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, b if mesh is None else shard_batch(b, mesh, accum), gen)
        losses.append(float(m["loss/total"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if grad is None:
            grad = _fd_grad(model).cpu()
    return losses, grad, secs


def _cos(torch, a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                                 dim=0).item()


@phase("mesh1")
def phase_mesh1(torch, tmp, smi_line):
    """One rank over NCCL: serving_mesh gives no mesh; the train step over
    make_mesh(-1, 1) (its gradient all-reduce, the global normaliser, the
    draws of the global batch) is the plain step at full width, B=32: the
    first loss bitwise, its gradient to cosine 0.99999 and the later losses
    to rel 1e-4 (the backward's scatter-adds are not bitwise from run to
    run, so neither is the plain step against itself); both timed in
    turns."""
    from oryon_tpu_torch.parallel import mesh as pm
    pm.init_distributed("cuda", "nccl", f"file://{tmp}/mesh1.store", 0, 1, local_rank=0)
    try:
        check(pm.serving_mesh(-1, 1, 8, device="cuda") is None, "serving_mesh on one rank gave a mesh")
        mesh = pm.make_mesh(-1, 1, device="cuda")
        check(mesh.shape == {"data": 1, "model": 1}, f"mesh {mesh.shape}")
        model = _full_train_model(torch, 17)
        init = _trainable(model)
        batches = _train_batches(torch, model, TRAIN_BATCH, range(40, 40 + MESH1_STEPS))
        runs = {"plain": [], "mesh": []}
        for m in (None, mesh, mesh, None):
            runs["plain" if m is None else "mesh"].append(
                _steps(torch, model, init, batches, m))
        (plain, plain2), meshed = runs["plain"], runs["mesh"][0]
        check(plain[0][0] == meshed[0][0], f"first loss plain {plain[0][0]} vs mesh "
                                           f"{meshed[0][0]}")
        cos = _cos(torch, plain[1], meshed[1])
        check(cos > 0.99999, f"first gradient cosine mesh vs plain {cos:.8f}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(meshed[0], plain[0]))
        rel_pp = max(abs(a - b) / abs(b) for a, b in zip(plain2[0], plain[0]))
        check(rel < 1e-4, f"losses plain {plain[0]} vs mesh {meshed[0]}")
        secs = {k: [t for r in v for t in r[2]] for k, v in runs.items()}
        ms = {k: 1e3 * float(np.median(v)) for k, v in secs.items()}
        spread = {k: (1e3 * min(v), 1e3 * max(v)) for k, v in secs.items()}
    finally:
        pm.shutdown()
    return {"ms": ms, "line": (
        f"serving_mesh None, mesh data=1 model=1 (nccl); B={TRAIN_BATCH} steps: losses "
        f"{', '.join(f'{v:.5f}' for v in plain[0])}, the first equal to the plain step's, "
        f"the first gradient's cosine {cos:.9f}, the losses within rel {rel:.1e} (plain "
        f"against plain {rel_pp:.1e}); median step plain {ms['plain']:.1f} ms "
        f"({spread['plain'][0]:.1f}-{spread['plain'][1]:.1f}), mesh {ms['mesh']:.1f} ms "
        f"({spread['mesh'][0]:.1f}-{spread['mesh'][1]:.1f}), {2 * MESH1_STEPS} steps each in "
        f"turns plain/mesh/mesh/plain: {TRAIN_BATCH / ms['plain'] * 1e3:.2f} vs "
        f"{TRAIN_BATCH / ms['mesh'] * 1e3:.2f} pairs/s on {smi_line}")}


def _serve_compare(torch, got, ref) -> dict:
    """Agreement of two predictors' results on the same requests: masks
    equal (fraction of pixels), largest pose difference (rad, m)."""
    same = np.mean([np.mean(g["mask_a"] == r["mask_a"]) * 0.5
                    + np.mean(g["mask_q"] == r["mask_q"]) * 0.5 for g, r in zip(got, ref)])
    rot, trans = _pose_err(np.stack([np.asarray(g["pose"]) for g in got]),
                           np.stack([np.asarray(r["pose"]) for r in ref]))
    return {"masks_same": float(same), "rot": rot, "trans": trans,
            "n_corrs_same": all(g["n_corrs"] == r["n_corrs"] for g, r in zip(got, ref))}


def _serving_model(torch):
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import full_oryon
    from oryon_tpu_torch.models.pointdsc import PointDSC
    gen = torch.Generator().manual_seed(0)
    model = random_init_(full_oryon(quant="int8"), gen)
    return model, random_init_(PointDSC(), gen)


def _predictor(model, pointdsc, mesh=None):
    from oryon_tpu_torch.infer import OryonPredictor
    return OryonPredictor(model, pointdsc, device=DEVICE, batch_size=8, img_size=(224, 224),
                          depth_hw=(480, 640), solver="pointdsc", mesh=mesh)


def _dp2_rank(torch, rank, pm):
    """mesh.data=2: 3 training steps at B=32 (16 a rank) and a served batch
    of 8 (4 a rank); rank 0 then runs both on one device, the other rank
    waiting at a barrier."""
    mesh = pm.make_mesh(2, 1, device="cuda")
    model = _full_train_model(torch, 21)
    pm.place_params(model, mesh)
    init = _trainable(model)
    batches = _train_batches(torch, model, TRAIN_BATCH, range(30, 30 + DP2_STEPS))
    (losses, grad, secs), counts = _counted(
        torch, lambda: _steps(torch, model, init, batches, mesh))
    out = {"losses": losses, "step_ms": [1e3 * s for s in secs],
           "train_counts": {k: counts[k] for k in ("k1", "k2")}}
    if rank == 0:
        ref_losses, ref_grad, ref_secs = _steps(torch, model, init, batches)
        out.update(ref_losses=ref_losses, ref_step_ms=[1e3 * s for s in ref_secs],
                   grad_cos=_cos(torch, grad, ref_grad))
    pm.barrier()
    del model, batches, init
    torch.cuda.empty_cache()

    smodel, pointdsc = _serving_model(torch)
    pred = _predictor(smodel, pointdsc, mesh)
    reqs = _requests(np.random.RandomState(4), 8, ["mug", "laptop"])
    results, counts = _counted(torch, lambda: pred.predict(reqs, return_masks=True))
    out["serve_counts"] = {k: counts[k] for k in ("k1", "k2")}
    out["serve_ms"] = 1e3 * _warm_times(torch, pred, reqs, TIMED_BATCHES)[0]
    # the batch program over the mesh, with the draws of one generator
    batch, text = pred._build_batch(reqs)
    got = pred._run(batch, text, generator=torch.Generator(device=DEVICE).manual_seed(9))
    if rank == 0:
        ref = _predictor(smodel, pointdsc)
        out["serve"] = _serve_compare(torch, results, ref.predict(reqs, return_masks=True))
        out["ref_serve_ms"] = 1e3 * _warm_times(torch, ref, reqs, TIMED_BATCHES)[0]
        out["halves"] = _halves_compare(torch, ref, batch, text, got)
    pm.barrier()
    return out


def _halves_compare(torch, ref, batch, text, got) -> dict:
    """One device runs each rank's 4 pairs as one batch, with the rows of the
    same generator's draws for the batch of 8: the outputs gathered from the
    two ranks must be these, bitwise (the kernels see the ranks' shapes)."""
    from oryon_tpu_torch.parallel.mesh import take_rows
    B = batch.corrs.shape[0]
    parts = []
    for rows in (np.arange(B // 2), np.arange(B // 2, B)):
        parts.append(ref._run(take_rows(batch, rows, B), take_rows(text, rows, B),
                              generator=torch.Generator(device=DEVICE).manual_seed(9),
                              rows=(B, rows)))
    same = {f: bool(torch.equal(getattr(got, f), torch.cat([getattr(p, f) for p in parts])))
            for f in ("mask_a", "mask_q", "corrs", "corr_valid", "n_corrs", "pred_rel_pose")}
    return same


def _tp2_rank(torch, rank, pm):
    """mesh.model=2 at full width, int8: the towers sharded, one served batch
    of 8 and the vision tower's output; rank 0 then serves the unsharded
    model."""
    import copy

    from oryon_tpu_torch.parallel.tp import shard_params_tp
    mesh = pm.make_mesh(1, 2, device="cuda")
    model, pointdsc = _serving_model(torch)
    ref_model = copy.deepcopy(model) if rank == 0 else None
    shard_params_tp(model, mesh)
    pred = _predictor(model, pointdsc, mesh)
    reqs = _requests(np.random.RandomState(4), 8, ["mug", "laptop"])
    results, counts = _counted(torch, lambda: pred.predict(reqs, return_masks=True))
    out = {"serve_counts": {k: counts[k] for k in ("k1", "k2")},
           "serve_ms": 1e3 * _warm_times(torch, pred, reqs, TIMED_BATCHES)[0]}
    x = torch.rand(4, 336, 336, 3, generator=torch.Generator().manual_seed(5)).to(DEVICE)
    batch, text = pred._build_batch(reqs)
    with torch.inference_mode():
        feats = model.vlm_visual(x).float()
        fwd = model(batch.anchor.rgb, batch.query.rgb, None, text)
    if rank == 0:
        ref = _predictor(ref_model, pointdsc)
        with torch.inference_mode():
            out["tower_cos"] = torch.nn.functional.cosine_similarity(
                feats.flatten(1), ref.model.vlm_visual(x).float().flatten(1)).min().item()
            ref_fwd = ref.model(batch.anchor.rgb, batch.query.rgb, None, text)
        out["featmap_cos"] = min(
            torch.nn.functional.cosine_similarity(a.float().flatten(1), b.float().flatten(1))
            .min().item() for a, b in zip(fwd[:2], ref_fwd[:2]))
        out["logit_err"] = max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(fwd[2:], ref_fwd[2:]))
        out["serve"] = _serve_compare(torch, results, ref.predict(reqs, return_masks=True))
    pm.barrier()
    return out


def _mp2_rank(rank, world, tmp):
    """One of the two ranks of dp2 and tp2 (gloo, both on cuda:0); writes
    its results, or the error, to ``tmp``."""
    import traceback

    import torch
    from oryon_tpu_torch.parallel import mesh as pm
    pm.init_distributed("cuda", "gloo", f"file://{tmp}/mp2.store", rank, world, local_rank=0)
    out = {}
    try:
        t0 = time.perf_counter()
        out["dp2"] = _dp2_rank(torch, rank, pm)
        out["dp2"]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["tp2"] = _tp2_rank(torch, rank, pm)
        out["tp2"]["s"] = time.perf_counter() - t0
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, os.path.join(tmp, f"mp2_rank{rank}.pt"))
        pm.shutdown()


def run_mp2(torch, tmp) -> list:
    """Spawn the two ranks; their results (a failed or late rank raises)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_mp2_rank, args=(2, tmp), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + MP2_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.perf_counter() < deadline, f"two-rank phases over {MP2_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [torch.load(os.path.join(tmp, f"mp2_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    for r, res in enumerate(ranks):
        check("error" not in res, f"rank {r}: {res.get('error')}")
    return ranks


def _counts_txt(ranks, key, what) -> str:
    return "; ".join(f"rank {r} K1 {res[key][what]['k1']} K2 {res[key][what]['k2']}"
                     for r, res in enumerate(ranks))


@phase("dp2")
def phase_dp2(torch, ranks, layers, smi_line):
    r0 = ranks[0]["dp2"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["ref_losses"]))
    check(all(res["dp2"]["losses"] == r0["losses"] for res in ranks),
          "the ranks logged different losses")
    check(rel < 1e-3, f"losses {r0['losses']} vs one device {r0['ref_losses']}")
    check(r0["grad_cos"] > 0.9999, f"fusion/decoder gradient cosine {r0['grad_cos']:.6f}")
    for r, res in enumerate(ranks):
        c = res["dp2"]
        check(c["train_counts"]["k1"] == layers * DP2_STEPS,
              f"rank {r}: K1 ran {c['train_counts']['k1']} times in {DP2_STEPS} steps")
        check(c["serve_counts"] == {"k1": layers, "k2": 1},
              f"rank {r}: serving launches {c['serve_counts']}")
    check(all(r0["halves"].values()),
          f"the two ranks' outputs differ from one device's runs of their pairs: {r0['halves']}")
    sv = r0["serve"]
    check(sv["masks_same"] > 0.99, f"served masks agree on {sv['masks_same']:.6f} of pixels "
                                   f"with one device's batch of 8")
    step = float(np.median(r0["step_ms"][1:]))
    ref_step = float(np.median(r0["ref_step_ms"][1:]))
    return {"line": (
        f"gloo, 2 ranks on the one card; {DP2_STEPS} steps at B={TRAIN_BATCH} "
        f"({TRAIN_BATCH // 2} a rank): losses {', '.join(f'{v:.5f}' for v in r0['losses'])} "
        f"vs one device {', '.join(f'{v:.5f}' for v in r0['ref_losses'])} (max rel "
        f"{rel:.2e}), first fusion/decoder gradient cosine {r0['grad_cos']:.7f}; "
        f"{_counts_txt(ranks, 'dp2', 'train_counts')}; step {step:.1f} ms (rank 0, median "
        f"after the first) vs one device {ref_step:.1f} ms; serving B=8 (4 a rank): masks, "
        f"correspondences and poses bitwise those of one device on each rank's 4 pairs with "
        f"the same draws; against one device's batch of 8 masks agree on "
        f"{sv['masks_same']:.6f} of pixels, poses {sv['rot']:.2e} rad / {sv['trans']:.2e} m "
        f"apart (random weights: a pose is not a continuous function of the features); "
        f"{_counts_txt(ranks, 'dp2', 'serve_counts')}; warm batch {r0['serve_ms']:.1f} ms vs "
        f"one device {r0['ref_serve_ms']:.1f} ms; {ranks[0]['dp2']['s']:.1f} s on {smi_line}")}


@phase("tp2")
def phase_tp2(torch, ranks, layers, smi_line):
    r0 = ranks[0]["tp2"]
    check(r0["tower_cos"] > 0.999, f"sharded vision tower cosine {r0['tower_cos']:.6f}")
    check(r0["featmap_cos"] > 0.999, f"sharded model's featmap cosine {r0['featmap_cos']:.6f}")
    for r, res in enumerate(ranks):
        check(res["tp2"]["serve_counts"] == {"k1": layers, "k2": 1},
              f"rank {r}: serving launches {res['tp2']['serve_counts']}")
    sv = r0["serve"]
    check(sv["masks_same"] > 0.99, f"served masks agree on {sv['masks_same']:.6f} of pixels")
    return {"line": (
        f"gloo, mesh.model=2 on the one card, full width, int8: vision tower cosine "
        f"{r0['tower_cos']:.6f} to the unsharded one, featmaps {r0['featmap_cos']:.6f}, mask "
        f"logits within {r0['logit_err']:.3e}; serving B=8: masks agree on "
        f"{sv['masks_same']:.6f} of pixels, correspondence counts "
        f"{'equal' if sv['n_corrs_same'] else 'differ'}, poses {sv['rot']:.2e} rad / "
        f"{sv['trans']:.2e} m from the unsharded model's; "
        f"{_counts_txt(ranks, 'tp2', 'serve_counts')} (K1 at 8 heads a rank); warm batch "
        f"{r0['serve_ms']:.1f} ms; {ranks[0]['tp2']['s']:.1f} s on {smi_line}")}



def _cli_losses(root, exp_name) -> list:
    path = os.path.join(root, "exp", exp_name, "logs", f"{exp_name}.metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r["train_loss/total"] for r in rows if "step" in r and "train_loss/total" in r]


@phase("cards")
def phase_cards(torch, n, tmp, smi_line):
    """``--cards N``: the CLIs over N cards of this host (NCCL, torchrun),
    against one card: one epoch of training at full width (B=32 over the
    64-pair tree, RANSAC validation on the 16-pair tree) with
    ``mesh.data=N`` and with ``mesh.data=N/2 mesh.model=2``, then an
    evaluation of each checkpoint the same way; the logged losses within
    rel 1e-3 of one card's, every CSV with the split's 16 rows."""
    check(torch.cuda.device_count() >= n, f"--cards {n}: {torch.cuda.device_count()} cards")
    write_real275_tree(os.path.join(tmp, "nocs_smoke"), np.random.RandomState(3), "cpu")
    write_shapenet6d_tree(os.path.join(tmp, "shapenet6d_smoke"), np.random.RandomState(4),
                          TRAIN_PAIRS)
    absent = [f"pretrained.{k}={tmp}/no_{k}" for k in ("clip", "swin", "catseg", "vocabulary")]
    common = [f"dataset.root={tmp}", "dataset.test.name=nocs_smoke",
              f"dataset.test.split={EVAL_SPLIT}", "model.size=full", "use_seed=true",
              f"exp_root={os.path.join(tmp, 'exp')}", f"pretrained.pointdsc={tmp}/no_pd",
              *absent]
    train = [*common, "dataset.train.name=shapenet6d_smoke", f"dataset.train.split={TRAIN_SPLIT}",
             f"dataset.batch_size={TRAIN_BATCH}", "training.n_epochs=1", "training.freq_save=1",
             "training.freq_valid=1", "seed=7"]
    test = [*common, f"dataset.batch_size={EVAL_BATCH}", "test.solver=ransac",
            "compute_vsd=false", "eval.ckpt=last", "seed=5"]
    meshes = {"one": [], "dp": [f"mesh.data={n}"], "dp_tp": [f"mesh.data={n // 2}", "mesh.model=2"]}
    here = os.path.dirname(os.path.abspath(__file__))
    secs = {}
    for script, args in (("run_train_torch.py", train), ("run_test_torch.py", test)):
        for name, mesh in meshes.items():
            launch = ([sys.executable] if name == "one" else
                      [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={n}"])
            t0 = time.perf_counter()
            done = subprocess.run([*launch, script, *args, f"exp_name={name}", *mesh], cwd=here,
                                  capture_output=True, text=True, timeout=600)
            secs[f"{script.split("_")[1]} {name}"] = time.perf_counter() - t0
            check(done.returncode == 0, f"{script} {' '.join(mesh)}: exit {done.returncode}: "
                                        f"{done.stderr[-2000:]}")
    losses = {name: _cli_losses(tmp, name) for name in meshes}
    rel = {name: max(abs(a - b) / abs(b) for a, b in zip(losses[name], losses["one"]))
           for name in ("dp", "dp_tp")}
    for name, r in rel.items():
        check(len(losses[name]) == len(losses["one"]) > 0 and r < 1e-3,
              f"{name}: logged losses {losses[name]} vs one card's {losses['one']}")
    for name in meshes:
        (csv,) = [f for f in os.listdir(os.path.join(tmp, "exp", name, "results"))
                  if f.endswith(".csv")]
        with open(os.path.join(tmp, "exp", name, "results", csv)) as f:
            check(len(f.read().splitlines()) == 2 * len(EVAL_PAIRS),
                  f"{name}: CSV rows != {2 * len(EVAL_PAIRS)}")
    return {"line": (
        f"{n} cards over NCCL, the CLIs at full width: training (B={TRAIN_BATCH}, one epoch, "
        f"validation) with mesh.data={n} and mesh.data={n // 2} mesh.model=2: logged loss "
        f"{losses['one'][0]:.6f} on one card, rel {rel['dp']:.1e} and {rel['dp_tp']:.1e} from "
        f"it; evaluation of each checkpoint the same way: {2 * len(EVAL_PAIRS)} CSV rows each; "
        f"command wall seconds (start-up included) "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f"; {smi_line}")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only the device, build and kernel phases")
    ap.add_argument("--cards", type=int, default=1, metavar="N",
                    help="with N > 1: device, build, the kernel phases and the CLIs over N "
                         "cards (torchrun, NCCL) only")
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
        "rope": phase_r1(torch, TIMED_LAUNCHES),
        "k3": phase_k3(torch, TIMED_LAUNCHES),
        "k4": phase_k4(torch, TIMED_LAUNCHES),
        "k2": phase_k2(torch, TIMED_LAUNCHES),
    }
    measured["k1f32"] = measured["k1"]["f32"]
    measured["k2fp32"] = measured["k2"]["fp32"]
    if args.kernels:
        return 0
    if args.cards > 1:
        tmp = tempfile.mkdtemp(prefix="oryon_cards_")
        try:
            phase_cards(torch, args.cards, tmp, dev["smi"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    phase_register(torch)
    counts, pred, reqs = phase_serve(torch, TIMED_BATCHES, args.profile)["state"]
    counts.update(phase_serve_optin(torch, pred, reqs, TIMED_BATCHES)["counts"])
    counts.update(phase_serve_fp32(torch, pred, reqs)["counts"])
    phase_serve_small(torch)
    counts.update(phase_serve_eva(torch, TIMED_BATCHES, TIMED_LAUNCHES)["counts"])
    layers = pred.model.vision_cfg.layers
    tmp = tempfile.mkdtemp(prefix="oryon_smoke_")
    try:
        pd_dir = phase_ckpt(torch, pred, reqs, tmp)["pd_dir"]
        del pred
        phase_cli(torch, tmp, pd_dir, layers)
        torch.cuda.empty_cache()
        eval_res = phase_eval(torch, tmp, pd_dir, layers, dev["smi"])
        torch.cuda.empty_cache()
        tree = write_train_tree(tmp)
        phase_native(torch, tmp, pd_dir, dev["smi"], tree)
        phase_train(torch, tmp, pd_dir, layers, dev["smi"], tree)
        torch.cuda.empty_cache()
        trained_pd = phase_pointdsc_train(torch, tmp, layers, dev["smi"])["pd_dir"]
        torch.cuda.empty_cache()
        phase_tools(torch, tmp, trained_pd, layers, dev["smi"], eval_res)
        torch.cuda.empty_cache()
        phase_overfit(torch)
        torch.cuda.empty_cache()
        towers = phase_train_towers(torch, TIMED_LAUNCHES, layers)
        measured["k1bwd"], counts["k1bwd"] = towers, towers["launches"]
        torch.cuda.empty_cache()
        small = phase_train_towers_small(torch, TIMED_LAUNCHES)
        measured["k1bwdf32"] = small["k1bwdf32"]
        counts["k1f32"], counts["k1bwdf32"] = small["counts"]["k1"], small["counts"]["k1bwd"]
        torch.cuda.empty_cache()
        phase_mesh1(torch, tmp, dev["smi"])
        torch.cuda.empty_cache()
        ranks = run_mp2(torch, tmp)
        phase_dp2(torch, ranks, layers, dev["smi"])
        phase_tp2(torch, ranks, layers, dev["smi"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    table = [   # key, wrapper, source, TPU kernel it replaces
        ("k1", "fused_mha_lanes_qkv", "mha_lanes.cu", "oryon_tpu/ops/pallas/mha_lanes.py:121"),
        ("k1i8", "fused_mha_lanes_qkv(qk_int8=True)", "mha_lanes.cu",
         "oryon_tpu/ops/pallas/mha_lanes.py:72"),
        ("k1f32", "fused_mha_lanes_qkv (f32)", "attn_f32_head.cuh",
         "oryon_tpu/ops/pallas/mha_lanes.py:45"),
        ("k1bwd", "MhaLanesFunction.backward", "attn_bwd_wgmma.cuh",
         "oryon_tpu/ops/pallas/mha_lanes.py:180"),
        ("k1bwdf32", "MhaLanesFunction.backward (f32)", "attn_bwd_f32_head.cuh",
         "oryon_tpu/ops/pallas/mha_lanes.py:180"),
        ("k2", "masked_argmin", "match_wgmma.cuh", "oryon_tpu/ops/matching.py:60"),
        ("k2fp32", "masked_argmin (fp32)", "match_tf32.cuh",
         "oryon_tpu/ops/pallas/match_kernel.py:60"),
        ("k3", "packed_window_attention", "swin_attn.cu", "oryon_tpu/ops/pallas/swin_attn.py:90"),
        ("k4", "band_window_attention", "swin_attn.cu", "oryon_tpu/ops/pallas/swin_attn.py:204"),
        ("k5", "flash_mha_padded", "flash.cu", "oryon_tpu/ops/flash.py:84"),
        ("rope", "rope_qk_", "rope.cu", None),   # R1: the JAX package has no EVA02 tower
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
