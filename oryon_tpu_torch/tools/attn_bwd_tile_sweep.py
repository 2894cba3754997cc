"""Time K1's head-dim-64 backward kernels under each configuration.

    python3 -m oryon_tpu_torch.tools.attn_bwd_tile_sweep [--rounds 2] [--iters 20]

Needs one CUDA card with nvcc.  Builds ``attn_bwd_tile_sweep.cu`` (the
header ``csrc/attn_bwd_wgmma.cuh`` instantiated for every (ring stages,
resident blocks) configuration of its table) into ``build/oryon_tpu_torch/``
and runs at the training shape [64, 577, 3072] (16 heads of 64, no key
masked).  Each query-tile configuration's d q, and each key-tile
configuration's d k and d v, is held bitwise equal to the library's entry.
Per round it prints, for the library's whole backward and for each
configuration alone, the registers and spills ptxas reported and the mean
time of ``iters`` launches (CUDA events).  The card's name and power limit
come first.  The kernel library itself always runs the defaults of
``launch`` in ``csrc/attn_bwd_wgmma.cuh``.
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

SHAPE, HEADS = (64, 577, 3 * 1024), 16


def build() -> tuple:
    """(loaded library, {kernel symbol: (registers, spill bytes)})."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "attn_bwd_tile_sweep.cu")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(_lib.BUILD_DIR, "libattn_bwd_tile_sweep.so")
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.oryon_bwd_sweep_config.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    lib.oryon_bwd_sweep_run.argtypes = [I, P, P, P, P, P, P, I, I, I, I, F, P]
    usage, key = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key = m.group(1)
            usage[key] = [None, None]
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[key][1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            usage[key][0] = int(m.group(1))
    return lib, usage


def symbol(cfg: tuple) -> str:
    """The mangled name of a configuration's kernel, as ptxas prints it."""
    kernel, st, mb = cfg
    return f"{('dq', 'dkv')[kernel]}_kernelILi{st}ELi{mb}E"


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
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
    ap.add_argument("--iters", type=int, default=20)
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
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    kmask = torch.zeros(L, device="cuda")
    dout = torch.randn((B, L, C), generator=g, device="cuda").to(torch.bfloat16)
    scale = (C // HEADS) ** -0.5

    def entry():
        return mha_lanes.run_backward_entry(mha_lanes.BWD_WGMMA, qkv, kmask, dout, HEADS,
                                            scale, False)[0]
    lib_dqkv = entry()
    dqkv = torch.zeros_like(qkv)
    stats = mha_lanes.backward_stats(qkv, HEADS)
    colsum = torch.empty((B * HEADS, L), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    configs, three = [], (ctypes.c_int * 3)()
    while lib.oryon_bwd_sweep_config(len(configs), three) == 0:
        configs.append(tuple(three))
    first_dq = next(i for i, c in enumerate(configs) if c[0] == 0)

    def run(cfg: int):
        _lib.check(lib.oryon_bwd_sweep_run(cfg, qkv.data_ptr(), kmask.data_ptr(),
                                           dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                                           colsum.data_ptr(), B, L, C, HEADS, scale, stream),
                   f"configuration {cfg}")
    held = {}
    for cfg, key in enumerate(configs):
        dqkv.zero_()
        run(first_dq)   # the row statistics the key-tile kernel reads
        run(cfg)
        torch.cuda.synchronize()
        part = slice(0, C) if key[0] == 0 else slice(C, 3 * C)
        held[cfg] = "bitwise equal" if torch.equal(dqkv[..., part], lib_dqkv[..., part]) \
            else "NOT EQUAL"
    for rnd in range(args.rounds):
        print(f"round {rnd}: the library's backward (both kernels and their launches) "
              f"{cuda_ms(entry, args.iters):.4f} ms", flush=True)
        for cfg, key in enumerate(configs):
            kernel, st, mb = key
            regs, spill = next((v for k, v in usage.items() if symbol(key) in k), (None, None))
            print(f"round {rnd}: {('query-tile', 'key-tile')[kernel]} kernel, "
                  f"stages {st}, blocks asked {mb}: {regs} registers, {spill} B "
                  f"spilled, {held[cfg]}, {cuda_ms(lambda: run(cfg), args.iters):.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
