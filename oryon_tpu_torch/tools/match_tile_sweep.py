"""Time the tensor-core matcher (K2, bf16 mode) under each block configuration.

    python3 -m oryon_tpu_torch.tools.match_tile_sweep [--rounds 2] [--iters 30]
                                                      [--splits 1,2,4,8] [--excluded 0.4]

Needs one CUDA card with nvcc.  Builds ``match_tile_sweep.cu`` (the kernel
header instantiated for every configuration of its table) into
``build/oryon_tpu_torch/``, runs the compacting pre-pass once at the serving
shape 8 x [5120, 32] x [36864, 32] with the given share of targets excluded at
random, then times the main kernel and its merge (CUDA events, mean of
``iters`` launches) under each configuration and each number of target
splits, holding the result bitwise against the library's (the reduction is
exact whatever the blocking).  Prints per round and configuration the
registers and spills ptxas reported and the times.  The card's name and power
limit come first.  The kernel library itself always runs the defaults of
``launch`` in ``csrc/match_wgmma.cuh`` and ``match_kernel.target_splits``.

``--ablate`` instead times the library's configuration with parts of the
main kernel taken out, to see what each costs alone and how far they overlap:
the reduction, the products, the TMA loads, in every combination (the results
are then wrong; only the time is read).  The parts are cut out of a copy of
the header in the build directory by text, so the option fails loudly when
the kernel's loop has changed.
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


def build() -> tuple:
    """(loaded library, {(consumers, stages, blocks, sets): (registers, spill bytes)})."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "match_tile_sweep.cu")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(_lib.BUILD_DIR, "libmatch_tile_sweep.so")
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.oryon_match_sweep_config.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    lib.oryon_match_sweep.argtypes = [I] + [P] * 10 + [I] * 5 + [P]
    usage, key = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        if "warning" in line.lower() or "serializ" in line.lower():
            print(line)
        m = re.search(r"match_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry" in line:
            key = tuple(int(x) for x in m.groups()) if m else None
            if key:
                usage[key] = [None, None]
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[key][1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            usage[key][0] = int(m.group(1))
    return lib, usage


# (name, text of csrc/match_wgmma.cuh, what stands there instead when the part is cut)
ABLATIONS = (
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
"""),
)


def ablate(src, tgt, bad, iters: int) -> None:
    """Build the library's configuration with each subset of ABLATIONS cut
    out and print the time of the main kernel and its merge."""
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = os.path.join(os.path.dirname(here), "csrc")
    work = os.path.join(_lib.BUILD_DIR, "match_ablate")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(csrc, "match_wgmma.cuh")) as f:
        text = f.read()
    for bit, (name, old, new) in enumerate(ABLATIONS):
        if text.count(old) != 1:
            raise RuntimeError(f"match_wgmma.cuh no longer holds the {name} as this tool "
                               "expects them")
        text = text.replace(old, f"#if ORYON_ABLATE & {1 << bit}\n{new}#else\n{old}#endif\n")
    with open(os.path.join(work, "match_wgmma.cuh"), "w") as f:
        f.write(text)
    with open(os.path.join(csrc, "hopper.cuh")) as f, \
            open(os.path.join(work, "hopper.cuh"), "w") as g:
        g.write(f.read())
    with open(os.path.join(work, "ablate.cu"), "w") as f:
        f.write('#include "match_wgmma.cuh"\n'
                'extern "C" int run(const void* src, const void* tgt16, const void* idx_map,\n'
                '    const void* counts, void* pb, void* pp, void* om, void* oa, int P, int S,\n'
                '    int N, int splits, void* stream) {\n'
                '  return int(oryon_match_wg::launch(src, nullptr, nullptr,\n'
                '      const_cast<void*>(tgt16), const_cast<void*>(idx_map),\n'
                '      const_cast<void*>(counts), pb, pp, om, oa, P, S, N, splits, 2,\n'
                '      static_cast<cudaStream_t>(stream)));\n}\n')
    builds = []
    for cut in range(1 << len(ABLATIONS)):
        so = os.path.join(work, f"ablate{cut}.so")
        builds.append((cut, so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DORYON_ABLATE={cut}", "-shared", "-o", so,
             os.path.join(work, "ablate.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    scratch = mk._bf16_scratch(src, tgt)
    out_min = torch.empty(src.shape[:2], dtype=torch.float32, device="cuda")
    out_arg = torch.empty(src.shape[:2], dtype=torch.int32, device="cuda")
    mk.run_bf16_phases(src, tgt, bad, mk.COMPACT, scratch, out_min, out_arg)
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
        without = [name for bit, (name, _, _) in enumerate(ABLATIONS) if cut >> bit & 1]
        print(f"without {', '.join(without) if without else 'nothing (the whole kernel)'}: "
              f"{cuda_ms(run, iters):.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--splits", default="1,2,4,8")
    ap.add_argument("--excluded", type=float, default=0.4)
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
    if args.ablate:
        ablate(src, tgt, bad, args.iters)
        return 0
    lib, usage = build()
    ref_min, ref_arg = mk.masked_argmin(src, tgt, bad, "bf16")
    stream = torch.cuda.current_stream().cuda_stream
    splits = [int(s) for s in args.splits.split(",")]

    configs, four = [], (ctypes.c_int * 4)()
    while lib.oryon_match_sweep_config(len(configs), four) == 0:
        configs.append(tuple(four))
    tgt16, idx_map, counts = mk._bf16_scratch(src, tgt)[:3]
    out_min, out_arg = torch.empty_like(ref_min), torch.empty_like(ref_arg)
    for rnd in range(args.rounds):
        for cfg, key in enumerate(configs):
            times = []
            for sp in splits:
                part_best = torch.empty((PAIRS, sp, SRC), dtype=torch.float32, device="cuda")
                part_pos = torch.empty((PAIRS, sp, SRC), dtype=torch.int32, device="cuda")

                def run(phases):
                    _lib.check(lib.oryon_match_sweep(
                        cfg, src.data_ptr(), tgt.data_ptr(), bad.data_ptr(), tgt16.data_ptr(),
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
            print(f"round {rnd}: consumers {key[0]}, stages {key[1]}, blocks asked {key[2]}, "
                  f"accumulator sets {key[3]}: "
                  f"{regs} registers, {spill} B spilled; ms by splits {{{', '.join(times)}}}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
