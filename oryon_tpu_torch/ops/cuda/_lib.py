"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file in ``oryon_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source and all started together, and
the objects are linked into one shared library with a plain C interface,
which is loaded with ``ctypes`` (``utils/shlib.py``).  The library lands in
``build/oryon_tpu_torch/`` at the root of the checkout, named by a hash of
the sources (``*.cu`` and ``*.cuh``) and flags, so an edited source is
rebuilt on first use and an unchanged one is reused.

Nothing here runs at import time: the library is built by the first call of
``library()``, which the kernel wrappers make on their first CUDA launch.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from oryon_tpu_torch.utils.shlib import BUILD_DIR, build_and_load

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes; every one returns a cudaError_t as int
SIGNATURES = {
    "oryon_fused_mha_lanes_bf16": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_fused_mha_lanes_wgmma_bf16": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_fused_mha_lanes_f32": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_fused_mha_lanes_f32_head": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_fused_mha_lanes_i8qk_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_fused_mha_lanes_i8qk_wgmma_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                              _F, _I, _P],
    "oryon_mha_lanes_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_mha_lanes_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_mha_lanes_bwd_f32_head": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_mha_lanes_bwd_wgmma_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                       _I, _P],
    "oryon_flash_mha_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_flash_mha_wgmma_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "oryon_packed_window_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _F, _P],
    "oryon_band_window_attention_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _F, _P],
    "oryon_packed_window_attention_wgmma_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                                 _I, _I, _F, _I, _P],
    "oryon_band_window_attention_wgmma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                               _I, _F, _I, _P],
    "oryon_masked_argmin_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "oryon_masked_argmin_wgmma_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _P],
    "oryon_masked_argmin_wgmma_tf32x3": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _I, _P],
    "oryon_rope_qk_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "oryon_rope_qk_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}   # path, seconds (0.0 when reused), ptxas summary


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _build(srcs, so: str) -> str:
    """Compile each ``.cu`` of ``srcs`` to an object, all at once, and link
    them into ``so``.  Returns the compilers' output (the ptxas lines)."""
    nvcc = _nvcc()
    tag = os.path.basename(so)
    objs, procs = [], []
    for s in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{tag}.{os.path.basename(s)[:-3]}.o")
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, s], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    outputs, failed = [], []
    for s, proc in procs:       # every compiler is waited for, failed or not
        out = proc.communicate()[0]
        outputs.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(s)} ({proc.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        res = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(outputs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        key = " ".join(NVCC_FLAGS).encode()
        for s in srcs:
            with open(s, "rb") as f:
                key += os.path.basename(s).encode() + f.read()
        built = {}

        def build(tmp):
            built["ptxas"] = _build(srcs, tmp)
        lib, so, seconds = build_and_load(
            BUILD_DIR, "liboryon_kernels", key, build,
            {name: (ctypes.c_int, argtypes) for name, argtypes in SIGNATURES.items()})
        log = so[:-3] + ".ptxas.txt"
        if "ptxas" in built:
            with open(log, "w") as f:
                f.write(built["ptxas"])
        ptxas = ""
        if os.path.exists(log):
            with open(log) as f:
                ptxas = f.read()
        build_info.update(path=so, seconds=seconds, ptxas=ptxas)
        _lib = lib
        return lib


class _ForwardOnly(torch.autograd.Function):
    """Runs a kernel wrapper with autograd off; its backward raises."""

    @staticmethod
    def forward(ctx, name, fn, *tensors):
        ctx.name = name
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.name} cannot be differentiated: the JAX package has no backward "
            "for this kernel either; train the towers with model.attn_impl=fused "
            "or einsum (and the Swin tower's attn_impl=einsum)")


def forward_only(name: str, fn, *tensors):
    """``fn(*tensors)``; when autograd would record it, through a node whose
    backward raises.  For the kernels that the JAX package gives no backward
    (no ``custom_vjp``; the stock flash kernel raises without backward block
    sizes): a forward pass is allowed, a gradient is not, on either device,
    and the plain version on the CPU is not differentiated in its stead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ForwardOnly.apply(name, fn, *tensors)
    return fn(*tensors)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a cudaError_t code)."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
