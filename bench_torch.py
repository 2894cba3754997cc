#!/usr/bin/env python
"""Benchmark of the PyTorch port: end-to-end image pairs per second through
the inference pipeline.  Counterpart of ``bench.py``.

    python3 bench_torch.py                      # on the card, full model
    python3 bench_torch.py --rounds 3 --iters 5
    python3 bench_torch.py --device cpu --size tiny --rounds 1 --iters 1
    python3 bench_torch.py --trace=DIR          # + a profiler trace, see below

Runs ``pipeline.make_run_fn`` at production shapes: B=8 pairs of 224² RGB,
480x640 depth, 80 prompts x 77 tokens encoded once outside the timed loop
(the per-class text cache), model forward (CLIP ViT-L/14@336 + Swin-B +
fusion + decoder) -> masked NN matching -> depth lift -> registration ->
ICP.  Weights are random from ``--seed``, for the model and for PointDSC.

Variants: the headline is the shipped serving default, the int8 CLIP tower +
PointDSC + ICP at the ``TestConfig`` settings; beside it the same with ICP
flipped, the bf16 tower (``quant="none"``) + PointDSC, and the int8 tower +
RANSAC (256 hypotheses, 1 mm).  The int8 and the bf16 model are two modules
with equal weights, both held on the device for the whole run (two copies of
about 1.9 GB of f32 parameters).

Timing: one warm call per variant, then ``--rounds`` rounds; in each round
every variant in turn runs ``--iters`` batches, the host clock around work
that ends in ``torch.cuda.synchronize()``.  Interleaving puts slow phases of
the host on every variant alike.  Per variant the median, minimum and
maximum pairs/s over the rounds; for the headline also the median time of
each pipeline stage by CUDA events (``outside`` is a batch's host time less
the span of its events) and the kernel launches of one batch.

Prints one JSON line last: {"metric", "value" (the headline's median),
"unit", "solver", "quant", "icp_refine", "icp_off_variant" (or
"icp_on_variant"), "bf16_parity_variant", "ransac_variant", "min", "max",
"stage_ms", "launches", "device", "rounds", "iters", "size"}.  On the CPU
no kernel launches and ``stage_ms`` is null.  Any failure exits non-zero.

``--trace=DIR`` (the counterpart of ``bench.py --trace``): after the timed
rounds, ``torch.profiler`` (CPU and CUDA activities) records
``TRACE_BATCHES`` warm batches of the headline on its inputs, the last one
synchronised; DIR gets the Chrome trace ``bench_trace.json`` and the table
``bench_trace.txt`` of the operations that took the most device time.  The
timed numbers and the JSON line are those of a run without it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

B = 8
IMG, DEPTH_HW = 224, (480, 640)
CAMERA = [591.0125, 0, 322.525, 0, 590.16775, 244.11084, 0, 0, 1]
STAGES = ("forward", "match", "solve", "icp", "pack")
TRACE_BATCHES = 10


def make_inputs(model, device):
    """(PairBatch, prompt ids [B, P, L]) from ``np.random.RandomState(0)``:
    RGB in [0, 1), depth in 600-900 mm, one camera, P templates of L tokens
    (start, one random id, end) as the model's text tower takes them."""
    import torch

    from oryon_tpu_torch.data.pair_batch import PairBatch, PairView

    P, L = model.fusion_cfg.num_prompts, model.text_cfg.context_length
    vocab = model.text_cfg.vocab_size
    rng = np.random.RandomState(0)
    rgb_a, rgb_q = (rng.rand(B, IMG, IMG, 3).astype(np.float32) for _ in range(2))
    depth_a, depth_q = ((rng.rand(B, *DEPTH_HW) * 300 + 600).astype(np.float32)
                        for _ in range(2))
    ids = np.zeros((B, P, L), np.int64)
    ids[:, :, 0] = vocab - 2
    ids[:, :, 1] = rng.randint(1, min(40000, vocab - 2), (B, P))
    ids[:, :, 2] = vocab - 1

    def t(a):
        return torch.as_tensor(a, device=device)

    def view(rgb, depth):
        return PairView(rgb=t(rgb), mask=torch.zeros((B, IMG, IMG), dtype=torch.uint8,
                                                     device=device),
                        depth=None, orig_depth=t(depth), eval_depth=None,
                        camera=t(np.tile(np.asarray(CAMERA, np.float32), (B, 1))),
                        pose=torch.eye(4, device=device).expand(B, 4, 4),
                        size=torch.tensor([DEPTH_HW] * B, dtype=torch.int32, device=device))

    n = 500
    batch = PairBatch(anchor=view(rgb_a, depth_a), query=view(rgb_q, depth_q),
                      prompt_ids=None,
                      corrs=torch.zeros((B, n, 4), dtype=torch.int64, device=device),
                      corr_valid=torch.zeros((B, n), dtype=torch.bool, device=device),
                      valid=torch.ones(B, device=device), rel_pose=None,
                      cls_id=np.zeros(B, np.int64), instance_id=np.arange(B).astype(str))
    return batch, t(ids)


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return str(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="full", choices=("full", "small", "tiny"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="DIR",
                    help="also write a profiler trace of warm headline batches to DIR")
    args = ap.parse_args(argv)

    import torch

    from oryon_tpu_torch.config import TestConfig
    from oryon_tpu_torch.infer import full_precision_matmuls
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import build_model, resolve_quant
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from oryon_tpu_torch.pipeline import PipelineConfig, make_run_fn

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    full_precision_matmuls()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(args.seed)
    int8_model = random_init_(build_model(args.size, quant=resolve_quant(args.size, "int8")), gen)
    bf16_model = build_model(args.size)
    bf16_model.load_state_dict(int8_model.state_dict())
    int8_model, bf16_model = (m.to(device).eval() for m in (int8_model, bf16_model))
    pointdsc = random_init_(PointDSC(PointDSCConfig()), gen).to(device).eval()

    batch, ids = make_inputs(int8_model, device)
    with torch.inference_mode():
        text_emb = int8_model.encode_prompts(ids)

    tc = TestConfig()
    icp = dict(icp_points=tc.icp_points, icp_iters=tc.icp_iters, icp_trim=tc.icp_trim)
    flip = "icp_off_variant" if tc.icp_refine else "icp_on_variant"
    variants = {   # key of the result line -> the program
        "value": make_run_fn(int8_model, PipelineConfig(
            solver="pointdsc", icp_refine=tc.icp_refine, **icp), pointdsc),
        flip: make_run_fn(int8_model, PipelineConfig(
            solver="pointdsc", icp_refine=not tc.icp_refine, **icp), pointdsc),
        "bf16_parity_variant": make_run_fn(bf16_model, PipelineConfig(
            solver="pointdsc", icp_refine=tc.icp_refine, **icp), pointdsc),
        "ransac_variant": make_run_fn(int8_model, PipelineConfig(
            solver="ransac", ransac_hypotheses=256, ransac_match_err=0.001,
            icp_refine=tc.icp_refine, **icp)),
    }
    noise_gen = torch.Generator(device=device).manual_seed(args.seed)

    def run_batches(run, n, events=None):
        """Seconds for n batches, the last one synchronised."""
        t0 = time.perf_counter()
        for _ in range(n):
            out = run(batch, text_emb, generator=noise_gen, stage_events=events)
        sync()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(out.packed).all()):
            raise RuntimeError("the pipeline's output is not finite")
        return dt

    for run in variants.values():   # warm: kernels built, allocator filled
        run_batches(run, 1)
    reset_launch_counts()
    run_batches(variants["value"], 1)
    launches = launch_counts()

    rates = {key: [] for key in variants}
    stage_ms = {name: [] for name in STAGES + ("outside",)}
    for _ in range(args.rounds):
        for key, run in variants.items():
            events = [] if key == "value" and on_card else None
            dt = run_batches(run, args.iters, events)
            rates[key].append(B * args.iters / dt)
            if events:
                per_batch = len(events) // args.iters     # start + one mark a stage
                span = 0.0
                for i in range(0, len(events), per_batch):
                    marks = [ev for _, ev in events[i:i + per_batch]]
                    for name, e0, e1 in zip(STAGES, marks, marks[1:]):
                        stage_ms[name].append(e0.elapsed_time(e1))
                    span += marks[0].elapsed_time(marks[-1])
                stage_ms["outside"].append((dt * 1e3 - span) / args.iters)

    if args.trace:
        from oryon_tpu_torch.utils.profiling import activities, write_trace
        with torch.profiler.profile(activities=activities()) as prof:
            run_batches(variants["value"], TRACE_BATCHES)
        table = write_trace(prof, args.trace, "bench_trace")
        print(f"trace: {TRACE_BATCHES} warm headline batches, table {table}", flush=True)

    line = {"metric": "e2e_image_pairs_per_sec", "unit": "pairs/s",
            "solver": "pointdsc", "quant": resolve_quant(args.size, "int8"),
            "icp_refine": tc.icp_refine}
    line.update({key: statistics.median(r) for key, r in rates.items()})
    line["min"] = {key: min(r) for key, r in rates.items()}
    line["max"] = {key: max(r) for key, r in rates.items()}
    line["stage_ms"] = ({name: statistics.median(v) for name, v in stage_ms.items()}
                        if on_card else None)
    line["launches"] = launches
    line["device"] = device_line(device)
    line.update(rounds=args.rounds, iters=args.iters, size=args.size)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
