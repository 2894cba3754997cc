#!/usr/bin/env python3
"""The program's spans over one cell's requests, on the card.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> [--turns 2]

Set-up and warm-up as ``perfbench/run.py`` makes them (the cell's weights,
views and engine from the seed), then, while the program has spans
(``oryon_tpu_torch.utils.profiling.set_spans``):

1. and 2. the profiled requests of a traced run of the benchmark
   (``traffic/serve_closed.profile``): the cell's ``trace_requests``
   traced with the card's activity alone and spans off (busy and idle),
   then, spans on, its ``label_requests`` traced with the host's operations
   too: the idle gaps by the innermost span or operation open at their
   start, the share no span or operation holds ("host"), and each span's
   kernel launches and host synchronisations, the calls held against the
   profile's device kernels with each graph launch taken as the kernels it
   ran (``lib/spans.launches_agree``);
3. ``--turns`` pairs of windows of ``--seconds`` each, spans off then on,
   unprofiled: the mean request time of each, and in the windows with spans
   on each span's host time and the counters.

A program without spans gives the windows with spans off alone: the
same command from a checkout of an older program times its requests.
One line a span on standard error; the result as one JSON line on standard
output.  Not run by the benchmark's runs.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.lib import common  # noqa: E402


def set_up(cell: dict, seed: int, device: str):
    """(predictor, next_request, sync) of the cell after its warm-up, made
    as a run of the benchmark makes them."""
    import torch

    from perfbench.lib import weights
    from perfbench.reference import pose as ref_pose
    from perfbench.traffic import serve_closed

    wl, cfg = cell["workload"], cell["config"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        spec, pspec = common.reference(cfg).Oryon(cfg), ref_pose.PointDSC(cfg["pointdsc"])
    predictor = serve_closed.build_program(cfg, weights.make_state(spec, gen, dev),
                                           weights.make_state(pspec, gen, dev), wl, dev,
                                           seed + 1)
    warm, next_request = serve_closed.make_requests(wl, seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for r in warm:
        predictor.predict(r)
    sync()
    return predictor, next_request, sync


def window(predictor, next_request, sync, seconds: float) -> dict:
    """Closed-loop requests for ``seconds``: their count and mean time."""
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        t1 = time.perf_counter()
        predictor.predict(next_request())
        lat.append(time.perf_counter() - t1)
    sync()
    return {"requests": len(lat), "mean_ms": statistics.fmean(lat) * 1e3}


def profiled(cell, predictor, next_request, sync, profiling, on_card: bool) -> dict:
    """Steps 1 and 2 of the module's list, made by ``serve_closed.profile``;
    spans off after them."""
    from perfbench.lib import spans as spans_lib
    from perfbench.traffic import serve_closed

    wl = cell["workload"]

    def serve(reqs, events=None):
        return predictor.predict(reqs, stage_events=events)

    device, _, _, counts = serve_closed.profile(wl, cell["config"], next_request, serve,
                                                serve_closed.Capture(predictor), sync, on_card,
                                                profiling)
    profiling.set_spans(False)
    profiling.take_spans()
    profiling.take_counters()
    lab = device["labelled"]
    n = max(counts["requests"], 1)
    launches = counts["request"]["launches"]
    return {
        "card_only": {"busy_s": device["busy_s"], "window_s": device["window_s"],
                      "idle_pct": 100.0 * (1 - device["busy_s"] / device["window_s"]),
                      "request_ms": 1e3 * device["request_s"]["card_only"]},
        "labelled": {"window_s": lab["window_s"],
                     "request_ms": 1e3 * device["request_s"]["with_host"],
                     "busy_s": lab["busy_s"], "idle_s": lab["idle_s"],
                     "idle_gaps": device["idle_gaps"],
                     "host_share_pct": 100.0 * lab["host_s"] / max(lab["idle_s"], 1e-12)},
        "counts": counts,
        "launches_per_request": launches / n if spans_lib.launches_agree(counts) else None,
        "launch_calls_vs_kernels": [launches, counts["graph_launches"], counts["graph_kernels"],
                                    counts["kernels"]],
        "syncs_per_request": counts["request"]["syncs"] / n,
    }


def measure(cell: dict, seed: int, seconds: float, turns: int, device: str = "cuda") -> dict:
    """The module's steps over one cell: the result line's data."""
    from perfbench.lib import spans as spans_lib
    t_start = time.perf_counter()
    predictor, next_request, sync = set_up(cell, seed, device)
    profiling = spans_lib.program_spans()
    has_spans = profiling is not None
    out = {"workload": cell["name"], "seed": seed, "spans": has_spans,
           "setup_s": time.perf_counter() - t_start, "card": common.card_identity(),
           "device": device}
    if has_spans:
        out.update(profiled(cell, predictor, next_request, sync, profiling, device == "cuda"))
    out["turns"], totals, counters, n_on = [], {}, {}, 0
    for _ in range(turns):
        turn = {"off": window(predictor, next_request, sync, seconds)}
        if has_spans:
            profiling.set_spans(True)
            turn["on"] = window(predictor, next_request, sync, seconds)
            profiling.set_spans(False)
            n_on += turn["on"]["requests"]
            for name, s in spans_lib.span_ms(profiling.take_spans()).items():
                t = totals.setdefault(name, {"calls": 0, "ms": 0.0})
                t["calls"] += s["calls"]
                t["ms"] += s["ms"]
            for k, v in profiling.take_counters().items():
                counters[k] = counters.get(k, 0) + v
        out["turns"].append(turn)
    if has_spans and n_on:
        out["span_ms_per_request"] = {k: v["ms"] / n_on for k, v in totals.items()}
        out["counters_per_request"] = {k: v / n_on for k, v in counters.items()}
        out["views_ms"] = out["span_ms_per_request"].get("engine.views")
    return out


def report(out: dict) -> None:
    """One line a span, the counters and the launch check, on standard error."""
    from perfbench.lib.spans import ROOT
    if not out.get("span_ms_per_request"):
        return
    host, by_span = out["span_ms_per_request"], out["counts"]["spans"]
    n = max(out["counts"]["requests"], 1)
    for name in sorted(set(host) | set(by_span), key=lambda k: -host.get(k, 0.0)):
        c = by_span.get(name, {"launches": 0, "syncs": 0})
        print(f"span {name}: host {host.get(name, 0.0):.3f} ms, launches "
              f"{c['launches'] / n:.1f}, syncs {c['syncs'] / n:.2f} a request (innermost)",
              file=sys.stderr)
    print(f"counters a request: {out['counters_per_request']}", file=sys.stderr)
    if out["launches_per_request"] is None:
        calls, graphs, graph_kernels, kernels = out["launch_calls_vs_kernels"]
        print(f"launch calls under {ROOT} {calls} ({graphs} graph launches, which ran "
              f"{graph_kernels} kernels) against {kernels} device kernels: more than 2% apart, "
              f"no launch count", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0, help="each window's length")
    ap.add_argument("--turns", type=int, default=2, help="pairs of windows, spans off / on")
    args = ap.parse_args(argv)
    common.set_environment()
    cell = common.load_cell(args.workload)
    common.require_cards(cell["workload"]["chips"])
    out = measure(cell, args.seed, args.seconds, args.turns)
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
