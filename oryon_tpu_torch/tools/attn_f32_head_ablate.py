"""Time K1's one-block-a-head f32 kernels with parts of them cut out.

    python3 -m oryon_tpu_torch.tools.attn_f32_head_ablate [--iters 50]

Needs one CUDA card with nvcc.  Copies ``csrc/attn_f32_head.cuh``,
``csrc/attn_bwd_f32_head.cuh`` (with ``hopper.cuh`` and the entries of
``csrc/mha_lanes_f32_head.cu``) into ``build/oryon_tpu_torch/``, puts each
part listed in ``PARTS`` under ``#if ORYON_ABLATE & bit`` with a stand-in
that writes what the part wrote (zeros, or nothing), and builds one library
with nothing cut, one for each part cut alone and one with every part cut
(the launch and the barriers alone).  Then, at the small and tiny towers'
path shapes (4 heads of 16), prints the device time of the forward and of
the backward with d kmask, each with the launch queue kept full (a sleeping
kernel first, then ``iters`` launches between two events).  The card's name
and power limit come first.  A cut kernel computes garbage: only its time is
read.  The parts are found in the headers by text, so the tool fails loudly
when a kernel has changed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from oryon_tpu_torch.ops.cuda import _lib

SHAPES = ((4, 65, 192), (16, 65, 192), (64, 65, 192), (16, 17, 192))
HEADS = 4
FWD, BWD = "attn_f32_head.cuh", "attn_bwd_f32_head.cuh"

# (name, header, text of the part, its stand-in); bit i cuts part i
PARTS = (
    ("TMA loads", FWD, """\
    mbar_arrive_expect_tx(bar_a, uint32_t(kBoxes * n * HD * 4));
#pragma unroll
    for (int i = 0; i < kBoxes; ++i) tma_load_tile(smem_u32(dst[i]), maps[i], bar_a, cols[i], 0, b);
""", """\
    mbar_arrive(bar_a);
"""),
    ("forward: S product", FWD, """\
  rows_dot_rows<HD>(qs, r0, (m + 3) / 4 * 4, ks, n, [&](int i, int j, float s) {
    if (i < m && j < L) S[i * ld + j] = __fadd_rn(__fmul_rn(s, scale), km[j]);
  });
""", """\
  for (int e = threadIdx.x; e < m * ld; e += kThreads) S[e] = 0.f;
"""),
    ("forward: softmax", FWD, """\
  // E = exp(S - rowmax) in place, the row sums beside
""", """\
  for (int i = threadIdx.x; i < L; i += kThreads) rowsum[i] = 1.f;
  if (false)
"""),
    ("forward: O product", FWD, """\
  square_dot_tile<HD, false>(S, ld, vs, m, L, [&](int i, int c, float4 o) {
""", """\
  for (int e = threadIdx.x; e < m * (HD / 4); e += kThreads)
    *reinterpret_cast<float4*>(ob + size_t(e / (HD / 4)) * C + 4 * (e % (HD / 4))) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  if (false) square_dot_tile<HD, false>(S, ld, vs, m, L, [&](int i, int c, float4 o) {
"""),
    ("backward: S and dP products", BWD, """\
  rows_dot_rows<HD>(qs, 0, n, ks, n, [&](int i, int j, float s) {
    if (i < L && j < L) P[i * ld + j] = __fadd_rn(__fmul_rn(s, scale), km[j]);
  });
  rows_dot_rows<HD>(os, 0, n, vs, n, [&](int i, int j, float s) {
    if (i < L && j < L) G[i * ld + j] = s;
  });
""", """\
  for (int e = threadIdx.x; e < 2 * lay.square_floats; e += kThreads) P[e] = 0.f;
"""),
    ("backward: row passes", BWD, """\
  // eight lanes a query row: P = exp(S - max) / sum, D = rowsum(P * dP), dS
""", """\
  if (false)
"""),
    ("backward: column pass", BWD, """\
  // two lanes a key (2L <= kThreads): each sums dS over half the query rows
  // in order and scales them in place, then the halves are added
""", """\
  if (slab != nullptr)
    for (int j = threadIdx.x; j < L; j += kThreads) slab[size_t(blockIdx.x) * L + j] = 0.f;
  if (false)
"""),
    ("backward: dV, dQ, dK products", BWD, """\
  square_dot_tile<HD, true>(P, ld, os, L, L, to(2));
  square_dot_tile<HD, false>(G, ld, ks, L, L, to(0));
  square_dot_tile<HD, true>(G, ld, qs, L, L, to(1));
""", """\
  for (int e = threadIdx.x; e < L * 3 * (HD / 4); e += kThreads)
    to(e % 3)(e / 3 / (HD / 4), e / 3 % (HD / 4), make_float4(0.f, 0.f, 0.f, 0.f));
"""),
    ("backward: d kmask sum", BWD, """\
  if (slab == nullptr) return;
""", """\
  return;
"""),
)


def queued_ms(fn, iters: int) -> float:
    """Mean device ms of fn() with the launch queue kept full: a sleeping
    kernel of about 2 ms first, then ``iters`` calls between two events."""
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


def build(work: str) -> list:
    """[(bits cut, library)] built from the headers with PARTS under
    ORYON_ABLATE: nothing, each part alone, every part."""
    csrc = _lib.CSRC
    for name in ("hopper.cuh", "mha_lanes_f32_head.cu"):
        with open(os.path.join(csrc, name)) as f, open(os.path.join(work, name), "w") as g:
            g.write(f.read())
    texts = {}
    for header in (FWD, BWD):
        with open(os.path.join(csrc, header)) as f:
            texts[header] = f.read()
    for bit, (name, header, old, new) in enumerate(PARTS):
        if texts[header].count(old) != 1:
            raise RuntimeError(f"{header} no longer holds the {name} as this tool expects it")
        texts[header] = texts[header].replace(
            old, f"#if ORYON_ABLATE & {1 << bit}\n{new}#else\n{old}#endif\n")
    for header, text in texts.items():
        with open(os.path.join(work, header), "w") as f:
            f.write(text)
    cuts = [0, *(1 << bit for bit in range(len(PARTS))), (1 << len(PARTS)) - 1]
    procs = []
    for cut in cuts:
        so = os.path.join(work, f"ablate{cut}.so")
        procs.append((cut, so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DORYON_ABLATE={cut}", "-shared", "-o", so,
             os.path.join(work, "mha_lanes_f32_head.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for cut, so, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on cut {cut} ({proc.returncode}):\n{out}")
        lib = ctypes.CDLL(so)
        for entry in ("oryon_fused_mha_lanes_f32_head", "oryon_mha_lanes_bwd_f32_head"):
            getattr(lib, entry).argtypes = _lib.SIGNATURES[entry]
        libs.append((cut, lib))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    work = os.path.join(_lib.BUILD_DIR, "attn_f32_head_ablate")
    os.makedirs(work, exist_ok=True)
    libs = build(work)
    g = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    cases = []
    for B, L, C3 in SHAPES:
        qkv = torch.randn((B, L, C3), generator=g, device="cuda")
        C = C3 // 3
        cases.append((qkv, torch.zeros(L, device="cuda"),
                      torch.randn((B, L, C), generator=g, device="cuda"),
                      torch.empty((B, L, C), device="cuda"), torch.empty_like(qkv),
                      torch.empty((B * HEADS, L), device="cuda"), torch.empty(L, device="cuda"),
                      (B, L, C, HEADS, (C // HEADS) ** -0.5)))
    for cut, lib in libs:
        if cut == 0:
            what = "nothing (the whole kernels)"
        elif cut == (1 << len(PARTS)) - 1:
            what = "every part"
        else:
            what = PARTS[cut.bit_length() - 1][0]
        times = []
        for qkv, kmask, dout, out, dqkv, slab, dkmask, (B, L, C, H, scale) in cases:
            def fwd():
                _lib.check(lib.oryon_fused_mha_lanes_f32_head(
                    qkv.data_ptr(), kmask.data_ptr(), out.data_ptr(), B, L, C, H, scale,
                    stream), f"forward, cut {cut}")

            def bwd():
                _lib.check(lib.oryon_mha_lanes_bwd_f32_head(
                    qkv.data_ptr(), kmask.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                    slab.data_ptr(), counter.data_ptr(), dkmask.data_ptr(), B, L, C, H, scale,
                    stream), f"backward, cut {cut}")
            times.append(f"[{B}, {L}, {3 * C}] {queued_ms(fwd, args.iters):.4f} / "
                         f"{queued_ms(bwd, args.iters):.4f}")
        print(f"without {what}: forward / backward ms " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
