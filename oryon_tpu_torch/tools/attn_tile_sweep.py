"""Time the wgmma attention kernel (K1) under each tile configuration.

    python3 -m oryon_tpu_torch.tools.attn_tile_sweep [--rounds 2] [--iters 50]

Needs one CUDA card with nvcc.  Builds ``attn_tile_sweep.cu`` (the kernel
header instantiated for every configuration of its table) into
``build/oryon_tpu_torch/``, holds each configuration against the plain
version at the ViT-L shape [16, 577, 3072] with 560 unmasked keys, and prints
per round and configuration the registers and spills ptxas reported, the max
abs error and the mean time of ``iters`` launches (CUDA events).  The card's
name and power limit come first.  The kernel library itself always
runs the defaults of ``launch_packed`` in ``csrc/attn_wgmma.cuh``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

SHAPE, HEADS, REAL = (16, 577, 3 * 1024), 16, 560


def build() -> tuple:
    """(loaded library, {config id: (registers, spill bytes)})."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "attn_tile_sweep.cu")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(_lib.BUILD_DIR, "libattn_tile_sweep.so")
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.oryon_sweep_config.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    lib.oryon_sweep_packed.argtypes = [I, P, P, P, I, I, I, I, F, P]
    # ptxas: "Compiling entry function '..attn_wgmma_kernelILi0ELi2ELi64ELi4ELi2EE..'",
    # then "N bytes spill stores", then "Used N registers"
    usage, key = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"attn_wgmma_kernelILi\d+ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            key = tuple(int(x) for x in m.groups())
            usage[key] = [None, None]
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[key][1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            usage[key][0] = int(m.group(1))
    return lib, usage


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib, usage = build()
    B, L, C3 = SHAPE
    C = C3 // 3
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    kmask = torch.where(torch.arange(L, device="cuda") < REAL, 0.0, -1e9)
    scale = (C // HEADS) ** -0.5
    ref = mha_lanes.reference_mha(qkv, kmask, HEADS, scale)
    out = torch.empty((B, L, C), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    configs, four = [], (ctypes.c_int * 4)()
    while lib.oryon_sweep_config(len(configs), four) == 0:
        configs.append(tuple(four))
    for rnd in range(args.rounds):
        for cfg, key in enumerate(configs):
            def run():
                _lib.check(lib.oryon_sweep_packed(cfg, qkv.data_ptr(), kmask.data_ptr(),
                                                  out.data_ptr(), B, L, C, HEADS, scale,
                                                  stream), f"configuration {cfg}")
            out.zero_()
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            regs, spill = usage.get(key, (None, None))
            print(f"round {rnd}: consumers {key[0]}, keys/tile {key[1]}, stages {key[2]}, "
                  f"blocks asked {key[3]}: {regs} registers, {spill} B spilled, max abs err "
                  f"{err:.3e}, {cuda_ms(run, args.iters):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
