"""Time the wgmma window-attention kernel (K3, K4) under each block configuration.

    python3 -m oryon_tpu_torch.tools.swin_tile_sweep [--rounds 2] [--iters 50]
                                                     [--images 16]

Needs one CUDA card with nvcc.  Builds ``swin_tile_sweep.cu`` (the kernel
header instantiated for every configuration of its table) into
``build/oryon_tpu_torch/``, and at both Swin-B stages ([98, 98] map, C = 128,
4 heads; [49, 49], C = 256, 8 heads; windows of 7 x 7, shifted-window mask in
the bias) holds K3's and K4's attention kernel against the plain versions
under each (consumer warpgroups a block, ring stages, resident blocks asked
for) and each item order (0 strided, 1 contiguous).  The bias pre-pass runs
once beforehand and is timed on its own.  Prints per round and configuration
the registers and spills ptxas reported, the max abs error and the mean time
of ``iters`` launches (CUDA events), and first the WMMA body's time at the
same shapes.  The card's name and power limit come first.  The kernel
library itself always runs the defaults of ``launch_packed`` and
``launch_band`` in ``csrc/swin_wgmma.cuh``.

``--ablate`` instead times the library's configuration with parts of the
kernel taken out, to see what each costs alone: the bias loads, the two
products, the softmax, the TMA loads, the output stores, and everything that
touches memory or everything that computes together (the results are then
wrong; only the time is read).  The parts are cut out of a copy of the header
in the build directory by text, so the option fails loudly when the kernel
has changed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

from oryon_tpu_torch.models.swin import shift_attention_mask, window_partition
from oryon_tpu_torch.ops.cuda import _lib, swin_attn as sa
from oryon_tpu_torch.tools.attn_tile_sweep import cuda_ms

STAGES = ((98, 128, 4), (49, 256, 8))   # padded map side, channels, heads
WINDOW = 7
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PACKED_ARGS = [P, P, P, P, P, I, I, I, I, I, F, I, P]
BAND_ARGS = [P, P, P, I, I, I, I, I, I, F, I, P]


def build() -> tuple:
    """(loaded library, {(band, warpgroups, stages, blocks): (registers, spill bytes)})."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "swin_tile_sweep.cu")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(_lib.BUILD_DIR, "libswin_tile_sweep.so")
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.oryon_swin_sweep_config.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    lib.oryon_swin_sweep_packed.argtypes = [I] + PACKED_ARGS
    lib.oryon_swin_sweep_band.argtypes = [I] + BAND_ARGS
    usage, key = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        if "warning" in line.lower() or "serializ" in line.lower():
            print(line)
        m = re.search(r"swin_wgmma_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry" in line:
            key = tuple(int(x) for x in m.groups()) if m else None
            if key:
                usage[key] = [None, None]
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[key][1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            usage[key][0] = int(m.group(1))
    return lib, usage


def stage_inputs(images: int, side: int, C: int, heads: int, g) -> dict:
    """The inputs of both kernels at one stage, the plain versions' outputs
    and the bias fragments the pre-pass leaves."""
    w, N, nw = WINDOW, WINDOW * WINDOW, (side // WINDOW) ** 2
    qkv_map = torch.randn((images, side, side, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn((1, heads, N, N), generator=g, device="cuda")
    mask = torch.from_numpy(shift_attention_mask(side, side, w, w // 2)).cuda()
    bias = (bias + mask[:, None]).contiguous()
    assert bias.shape[0] == nw
    scale = (C // heads) ** -0.5
    q, k, v = (t.contiguous() for t in window_partition(qkv_map, w).chunk(3, dim=-1))
    d = dict(qkv_map=qkv_map, q=q, k=k, v=v, bias=bias, heads=heads, scale=scale, C=C,
             side=side, images=images,
             ref3=sa.packed_window_attention_plain(q, k, v, bias, heads, scale),
             ref4=sa.band_window_attention_plain(qkv_map, bias, heads, w, scale),
             frag3=sa._frag_scratch(bias, torch.bfloat16),
             frag4=sa._frag_scratch(bias, torch.float32))
    d["out3"], d["out4"] = torch.empty_like(d["ref3"]), torch.empty_like(d["ref4"])
    return d


def packed_args(d: dict, order: int, stream: int) -> list:
    Bw, N, C = d["q"].shape
    return [d["q"].data_ptr(), d["k"].data_ptr(), d["v"].data_ptr(), d["frag3"].data_ptr(),
            d["out3"].data_ptr(), Bw, d["bias"].shape[0], N, C, d["heads"], d["scale"], order,
            stream]


def band_args(d: dict, order: int, stream: int) -> list:
    return [d["qkv_map"].data_ptr(), d["frag4"].data_ptr(), d["out4"].data_ptr(), d["images"],
            d["side"], d["side"], d["C"], d["heads"], WINDOW, d["scale"], order, stream]


def prepass_and_yardsticks(data: list, iters: int) -> None:
    """Run the bias pre-pass into each stage's fragments (they stay for the
    sweep), and print its time, the library's whole call and the WMMA body's
    time at the same shapes."""
    lib = _lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    for i, d in enumerate(data):
        q, k, v, m, b, h, s = (d[n] for n in ("q", "k", "v", "qkv_map", "bias", "heads", "scale"))
        b16 = b.to(torch.bfloat16)
        Bw, N, C = q.shape

        def old3():
            _lib.check(lib.oryon_packed_window_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), b16.data_ptr(), d["out3"].data_ptr(),
                Bw, b.shape[0], N, C, h, s, stream), "K3 WMMA body")

        def old4():
            _lib.check(lib.oryon_band_window_attention_bf16(
                m.data_ptr(), b.data_ptr(), d["out4"].data_ptr(), d["images"], d["side"],
                d["side"], C, h, WINDOW, s, stream), "K4 WMMA body")
        print(f"stage {i + 1}: K3 whole call "
              f"{cuda_ms(lambda: sa.packed_window_attention(q, k, v, b, h, s), iters):.4f} ms, "
              f"pre-pass {cuda_ms(lambda: sa.run_packed_phases(q, k, v, b, h, s, sa.BIAS, d['frag3'], d['out3']), iters):.4f}, "
              f"kernel {cuda_ms(lambda: sa.run_packed_phases(q, k, v, b, h, s, sa.ATTEND, d['frag3'], d['out3']), iters):.4f}, "
              f"WMMA body {cuda_ms(old3, iters):.4f}; K4 whole call "
              f"{cuda_ms(lambda: sa.band_window_attention(m, b, h, WINDOW, s), iters):.4f} ms, "
              f"pre-pass {cuda_ms(lambda: sa.run_band_phases(m, b, h, WINDOW, s, sa.BIAS, d['frag4'], d['out4']), iters):.4f}, "
              f"kernel {cuda_ms(lambda: sa.run_band_phases(m, b, h, WINDOW, s, sa.ATTEND, d['frag4'], d['out4']), iters):.4f}, "
              f"WMMA body {cuda_ms(old4, iters):.4f}", flush=True)


# (name, [(text of csrc/swin_wgmma.cuh, what stands there instead when the part is cut)])
ABLATIONS = (
    ("bias loads", [(
        """    bias.load(p.frag, size_t(wi) * p.heads + h, tid);
""",
        """#pragma unroll
    for (int j = 0; j < (BAND ? 8 : 4); ++j) bias.v[j] = {};
""")]),
    ("products", [(
        """    wgmma_ss(s, q_desc, k_desc, 0);
    wgmma_ss(s, q_desc + 2, k_desc + 2, 1);
""", ""), (
        """      wgmma_rs_tb_n32(o, pk[4 * kk + 0], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3],
                      v_desc + kk * (1024 >> 4), kk > 0);
""", "")]),
    ("softmax", [(
        """    softmax_tile<BAND>(s, bias, p.scale, pk);
""",
        """#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pk[i] = pack_bf16(s[2 * i] + bias.at(i / 2, 0), s[2 * i + 1] + bias.at(i / 2, 3));
    }
""")]),
    ("TMA loads", [(
        """        mbar_arrive_expect_tx(full, p.tx_bytes);
        if constexpr (BAND) {
          const int b = win / p.nw;
          const int wi = win - b * p.nw;
          const int y = (wi / p.nwx) * p.w;
          const int x = (wi % p.nwx) * p.w;
          tma_load_tile4(dst, &map_q, full, col, x, y, b);
          tma_load_tile4(dst + kTileBytes, &map_k, full, p.col_k + col, x, y, b);
          tma_load_tile4(dst + 2 * kTileBytes, &map_v, full, p.col_v + col, x, y, b);
        } else {
          tma_load_tile(dst, &map_q, full, col, 0, win);
          tma_load_tile(dst + kTileBytes, &map_k, full, p.col_k + col, 0, win);
          tma_load_tile(dst + 2 * kTileBytes, &map_v, full, p.col_v + col, 0, win);
        }
""",
        """        mbar_arrive(full);
""")]),
    ("output stores", [(
        """      if (out_off[i] >= 0) {
""",
        """      if (out_off[i] >= 0 && val.x == 0x7fc17fc2u && val.w == 0x7fc37fc4u) {
""")]),
)
# which parts are cut together: nothing, each alone, all memory traffic, all arithmetic
CUTS = (0, 1, 2, 4, 8, 16, 1 | 8 | 16, 2 | 4)


def ablate(data: list, iters: int) -> None:
    """Build the library's configuration with each of CUTS taken out of the
    kernel and print the attention kernel's time at both stages."""
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = os.path.join(os.path.dirname(here), "csrc")
    work = os.path.join(_lib.BUILD_DIR, "swin_ablate")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(csrc, "swin_wgmma.cuh")) as f:
        text = f.read()
    for bit, (name, pairs) in enumerate(ABLATIONS):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"swin_wgmma.cuh no longer holds the {name} as this tool "
                                   "expects them")
            text = text.replace(old, f"#if ORYON_ABLATE & {1 << bit}\n{new}#else\n{old}#endif\n")
    with open(os.path.join(work, "swin_wgmma.cuh"), "w") as f:
        f.write(text)
    for name in ("attn_wgmma.cuh", "hopper.cuh"):
        shutil.copy(os.path.join(csrc, name), os.path.join(work, name))
    with open(os.path.join(work, "ablate.cu"), "w") as f:
        f.write('#include "swin_wgmma.cuh"\n'
                'namespace wg = oryon_swin_wg;\n'
                'extern "C" int run_packed(const void* q, const void* k, const void* v,\n'
                '    const void* frag, void* out, int Bw, int nw, int N, int C, int heads,\n'
                '    float scale, int order, void* stream) {\n'
                '  return int(wg::launch_packed(q, k, v, frag, out, Bw, nw, N, C, heads, scale,\n'
                '                               order, static_cast<cudaStream_t>(stream)));\n}\n'
                'extern "C" int run_band(const void* qkv_map, const void* frag, void* out,\n'
                '    int B, int Hp, int Wp, int C, int heads, int window, float scale,\n'
                '    int order, void* stream) {\n'
                '  return int(wg::launch_band(qkv_map, frag, out, B, Hp, Wp, C, heads, window,\n'
                '                             scale, order, static_cast<cudaStream_t>(stream)));\n}\n')
    builds = []
    for cut in CUTS:
        so = os.path.join(work, f"ablate{cut}.so")
        builds.append((cut, so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DORYON_ABLATE={cut}", "-shared", "-o", so,
             os.path.join(work, "ablate.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    stream = torch.cuda.current_stream().cuda_stream
    for cut, so, proc in builds:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
        lib = ctypes.CDLL(so)
        lib.run_packed.argtypes, lib.run_band.argtypes = PACKED_ARGS, BAND_ARGS
        times = []
        for i, d in enumerate(data):
            a3, a4 = packed_args(d, 0, stream), band_args(d, 0, stream)
            t3 = cuda_ms(lambda: _lib.check(lib.run_packed(*a3), f"cut {cut}"), iters)
            t4 = cuda_ms(lambda: _lib.check(lib.run_band(*a4), f"cut {cut}"), iters)
            times.append(f"stage {i + 1} K3 {t3:.4f} K4 {t4:.4f}")
        without = [name for bit, (name, _) in enumerate(ABLATIONS) if cut >> bit & 1]
        print(f"without {', '.join(without) if without else 'nothing (the whole kernel)'}: "
              f"{'; '.join(times)} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--ablate", action="store_true",
                    help="time the library's configuration with parts cut out instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(8)
    data = [stage_inputs(args.images, side, C, heads, g) for side, C, heads in STAGES]
    prepass_and_yardsticks(data, args.iters)
    if args.ablate:
        ablate(data, args.iters)
        return 0
    lib, usage = build()
    stream = torch.cuda.current_stream().cuda_stream
    configs, three = [], (ctypes.c_int * 3)()
    while lib.oryon_swin_sweep_config(len(configs), three) == 0:
        configs.append(tuple(three))
    for rnd in range(args.rounds):
        for cfg, key in enumerate(configs):
            for order in (0, 1):
                cells = []
                for i, d in enumerate(data):
                    for band, fn, make, out, ref in (
                            (0, lib.oryon_swin_sweep_packed, packed_args, "out3", "ref3"),
                            (1, lib.oryon_swin_sweep_band, band_args, "out4", "ref4")):
                        a = [cfg] + make(d, order, stream)

                        def run():
                            _lib.check(fn(*a), f"configuration {cfg}")
                        d[out].zero_()
                        run()
                        torch.cuda.synchronize()
                        err = (d[out].float() - d[ref].float()).abs().max().item()
                        cells.append(f"stage {i + 1} {'K4' if band else 'K3'} "
                                     f"{cuda_ms(run, args.iters):.4f} ms (err {err:.1e})")
                regs = "/".join(f"{usage.get((band, *key), (None, None))[0]} regs "
                                f"{usage.get((band, *key), (None, None))[1]} B spilled"
                                for band in (0, 1))
                print(f"round {rnd}: warpgroups {key[0]}, stages {key[1]}, blocks asked {key[2]}, "
                      f"order {order} [K3/K4 {regs}]: {'; '.join(cells)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
