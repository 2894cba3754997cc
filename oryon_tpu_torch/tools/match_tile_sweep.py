"""Time the tensor-core matcher (K2) under each block configuration.

    python3 -m oryon_tpu_torch.tools.match_tile_sweep [--precision bf16|fp32]
        [--rounds 2] [--iters 30] [--splits 1,2,4,8] [--excluded 0.4] [--ablate]

Needs one CUDA card with nvcc.  Builds ``match_tile_sweep.cu`` (the kernel
headers instantiated for every configuration of its tables) into
``build/oryon_tpu_torch/``, runs the mode's pre-pass once at the serving
shape 8 x [5120, 32] x [36864, 32] with the given share of targets excluded at
random, then times the main kernel and its merge (CUDA events, mean of
``iters`` launches) under each configuration and each number of target
splits, holding the result bitwise against the library's (the reduction is
exact whatever the blocking).  ``--precision`` picks the mode: bf16
(``csrc/match_wgmma.cuh``, the default) or fp32 (the split-TF32 kernel of
``csrc/match_tf32.cuh``).  Prints per round and configuration the registers
and spills ptxas reported and the times.  The card's name and power limit
come first.  The kernel library itself always runs the defaults of
``launch`` / ``launch_tf32x3`` and ``match_kernel.target_splits``.

``--ablate`` instead times the library's configuration of the mode with
parts of the main kernel taken out, to see what each costs alone and how far
they overlap: the reduction, the products, the TMA loads, in every
combination (the results are then wrong; only the time is read).  The parts
are cut out of a copy of the header in the build directory by text, so the
option fails loudly when the kernel's loop has changed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from oryon_tpu_torch.ops.cuda import _lib, match_kernel as mk
from oryon_tpu_torch.tools.attn_tile_sweep import cuda_ms

PAIRS, SRC, TGT = 8, 5120, 192 * 192


# per mode: the kernel's name in ptxas's lines, the sweep library's entries
KERNEL_NAMES = {"bf16": r"match_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                "fp32": r"match_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)E"}
SWEEP_ENTRIES = {"bf16": ("oryon_match_sweep_config", "oryon_match_sweep"),
                 "fp32": ("oryon_match_sweep_tf32_config", "oryon_match_sweep_tf32")}


def build(precision: str = "bf16") -> tuple:
    """(loaded library, {configuration: (registers, spill bytes)}) for the
    mode's kernel; a configuration is (consumers, stages, blocks, sets), sets
    1 for fp32."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "match_tile_sweep.cu")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(_lib.BUILD_DIR, "libmatch_tile_sweep.so")
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    config_entry, sweep_entry = SWEEP_ENTRIES[precision]
    getattr(lib, config_entry).argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    getattr(lib, sweep_entry).argtypes = [I] + [P] * 10 + [I] * 5 + [P]
    usage, key = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        if "warning" in line.lower() or "serializ" in line.lower():
            print(line)
        m = re.search(KERNEL_NAMES[precision], line)
        if "Compiling entry" in line:
            key = (tuple(int(x) for x in m.groups()) + (1,) * (precision == "fp32")
                   if m else None)
            if key:
                usage[key] = [None, None]
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[key][1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            usage[key][0] = int(m.group(1))
    return lib, usage


# mode -> (header, launcher, ((name, text of the header, what stands there
# instead when the part is cut), ...))
ABLATIONS = {
    "bf16": ("match_wgmma.cuh", "launch", (
        ("reduction",
         """      mask_tile(d, position(it), count, c2);
      max_tile(d, mine, tmax);
      scan_tile(d, position(it), c2, mine, tmax, best, bpos);
""",
         """      best[0] = fmaxf(best[0], d[0]);
      best[1] = fmaxf(best[1], d[2]);
"""),
        ("products",
         """      issue_tile(d, a, tile_smem(it));
      wgmma_wait<0>();
""",
         ""),
        ("TMA loads",
         """        mbar_arrive_expect_tx(bar_full + stage * 8, kTileBytes);
        tma_load_tile(base + stage * kTileBytes, &map_t, bar_full + stage * 8, 0,
                      (tile0 + it) * kBN, pair);
""",
         """        mbar_arrive(bar_full + stage * 8);
"""))),
    "fp32": ("match_tf32.cuh", "launch_tf32x3", (
        ("reduction",
         """    mask_tile(d, t0, count, c2);
    max_tile(d, mine, tmax);
    scan_tile(d, t0, c2, mine, tmax, best, bpos);
""",
         """    best[0] = fmaxf(best[0], d[0]);
    best[1] = fmaxf(best[1], d[2]);
"""),
        ("products",
         """    issue_tile_tf32(d, a_hi, a_lo, tile, tile + kPartBytes);
    wgmma_wait<0>();
""",
         ""),
        ("TMA loads",
         """        mbar_arrive_expect_tx(bar_full + stage * 8, kStageBytes32);
        tma_load_tile(dst, &map_t, bar_full + stage * 8, 0, (tile0 + it) * kBN, 2 * pair);
        tma_load_tile(dst + kPartBytes, &map_t, bar_full + stage * 8, 0, (tile0 + it) * kBN,
                      2 * pair + 1);
""",
         """        mbar_arrive(bar_full + stage * 8);
"""))),
}


def ablate(src, tgt, bad, iters: int, precision: str = "bf16") -> None:
    """Build the library's configuration of the mode with each subset of its
    ABLATIONS cut out and print the time of the main kernel and its merge."""
    header, launcher, parts = ABLATIONS[precision]
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = os.path.join(os.path.dirname(here), "csrc")
    work = os.path.join(_lib.BUILD_DIR, f"match_ablate_{precision}")
    os.makedirs(work, exist_ok=True)
    for name in ("hopper.cuh", "match_wgmma.cuh", "match_tf32.cuh"):
        with open(os.path.join(csrc, name)) as f, open(os.path.join(work, name), "w") as g:
            g.write(f.read())
    with open(os.path.join(csrc, header)) as f:
        text = f.read()
    for bit, (name, old, new) in enumerate(parts):
        if text.count(old) != 1:
            raise RuntimeError(f"{header} no longer holds the {name} as this tool expects them")
        text = text.replace(old, f"#if ORYON_ABLATE & {1 << bit}\n{new}#else\n{old}#endif\n")
    with open(os.path.join(work, header), "w") as f:
        f.write(text)
    with open(os.path.join(work, "ablate.cu"), "w") as f:
        f.write(f'#include "{header}"\n'
                'extern "C" int run(const void* src, const void* rows, const void* idx_map,\n'
                '    const void* counts, void* pb, void* pp, void* om, void* oa, int P, int S,\n'
                '    int N, int splits, void* stream) {\n'
                f'  return int(oryon_match_wg::{launcher}(src, nullptr, nullptr,\n'
                '      const_cast<void*>(rows), const_cast<void*>(idx_map),\n'
                '      const_cast<void*>(counts), pb, pp, om, oa, P, S, N, splits, 2,\n'
                '      static_cast<cudaStream_t>(stream)));\n}\n')
    builds = []
    for cut in range(1 << len(parts)):
        so = os.path.join(work, f"ablate{cut}.so")
        builds.append((cut, so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DORYON_ABLATE={cut}", "-shared", "-o", so,
             os.path.join(work, "ablate.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    scratch = mk._scratch(src, tgt, precision)
    out_min = torch.empty(src.shape[:2], dtype=torch.float32, device="cuda")
    out_arg = torch.empty(src.shape[:2], dtype=torch.int32, device="cuda")
    mk.run_phases(src, tgt, bad, mk.COMPACT, scratch, out_min, out_arg, precision)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    for cut, so, proc in builds:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
        lib = ctypes.CDLL(so)
        lib.run.argtypes = [P] * 8 + [I] * 4 + [P]

        def run():
            _lib.check(lib.run(src.data_ptr(), *(t.data_ptr() for t in scratch),
                               out_min.data_ptr(), out_arg.data_ptr(), PAIRS, SRC, TGT,
                               scratch[3].shape[1], stream), f"ablation {cut}")
        without = [name for bit, (name, _, _) in enumerate(parts) if cut >> bit & 1]
        what = ", ".join(without) if without else "nothing (the whole kernel)"
        print(f"{precision}, without {what}: {cuda_ms(run, iters):.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--splits", default="1,2,4,8")
    ap.add_argument("--excluded", type=float, default=0.4)
    ap.add_argument("--precision", choices=mk.PRECISIONS, default="bf16",
                    help="the mode whose kernel is timed")
    ap.add_argument("--ablate", action="store_true",
                    help="time the library's configuration with parts cut out instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(2)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)
    src = unit(torch.randn(PAIRS, SRC, 32, generator=g, device="cuda"))
    tgt = unit(torch.randn(PAIRS, TGT, 32, generator=g, device="cuda"))
    bad = torch.rand(PAIRS, TGT, generator=g, device="cuda") < args.excluded
    prec = args.precision
    if args.ablate:
        ablate(src, tgt, bad, args.iters, prec)
        return 0
    lib, usage = build(prec)
    config_entry, sweep_entry = (getattr(lib, name) for name in SWEEP_ENTRIES[prec])
    ref_min, ref_arg = mk.masked_argmin(src, tgt, bad, prec)
    stream = torch.cuda.current_stream().cuda_stream
    splits = [int(s) for s in args.splits.split(",")]

    configs, four = [], (ctypes.c_int * 4)()
    while config_entry(len(configs), four) == 0:
        configs.append(tuple(four))
    rows, idx_map, counts = mk._scratch(src, tgt, prec)[:3]
    out_min, out_arg = torch.empty_like(ref_min), torch.empty_like(ref_arg)
    for rnd in range(args.rounds):
        for cfg, key in enumerate(configs):
            times = []
            for sp in splits:
                part_best = torch.empty((PAIRS, sp, SRC), dtype=torch.float32, device="cuda")
                part_pos = torch.empty((PAIRS, sp, SRC), dtype=torch.int32, device="cuda")

                def run(phases):
                    _lib.check(sweep_entry(
                        cfg, src.data_ptr(), tgt.data_ptr(), bad.data_ptr(), rows.data_ptr(),
                        idx_map.data_ptr(), counts.data_ptr(), part_best.data_ptr(),
                        part_pos.data_ptr(), out_min.data_ptr(), out_arg.data_ptr(), PAIRS, SRC,
                        TGT, sp, phases, stream), f"configuration {cfg}")
                out_arg.fill_(-1)
                run(mk.COMPACT | mk.REDUCE)
                torch.cuda.synchronize()
                ok = torch.equal(out_min, ref_min) and torch.equal(out_arg, ref_arg)
                times.append(f"{sp}: {cuda_ms(lambda: run(mk.REDUCE), args.iters):.4f}"
                             + ("" if ok else " WRONG"))
            regs, spill = usage.get(key, (None, None))
            print(f"round {rnd}, {prec}: consumers {key[0]}, stages {key[1]}, blocks asked "
                  f"{key[2]}, accumulator sets {key[3]}: "
                  f"{regs} registers, {spill} B spilled; ms by splits {{{', '.join(times)}}}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
