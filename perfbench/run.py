#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for.  The cell's files are found by name: ``perfbench/workloads/<cell>.json``
(its configuration, traffic mix, chips and limits),
``perfbench/configs/<config>.json`` and ``perfbench/traffic/<traffic>.json``
(the mix's parameters, and the name of the generator
``perfbench/traffic/<generator>.py`` that reads them); the metrics it reports
are those ``BENCHMARK.json`` gives it, each per-layer one read by
``perfbench/layers/<metric>.py``.  With ``--trace 0`` the line holds the
end-to-end metrics, with ``--trace 1`` the per-layer ones and a breakdown.
Without a card, or with JAX loaded in the process, it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.lib import common  # noqa: E402


def checks_of(numbers: dict, limits: dict, missing: list) -> list:
    """Each number compared, beside its limit."""
    out = [{"name": k, "value": numbers.get(k), "limit": lim,
            "ok": numbers.get(k) is not None and numbers[k] <= lim}
           for k, lim in limits.items()]
    out.append({"name": "unanswered", "value": len(missing), "limit": 0,
                "ok": not missing})
    return out


def result_line(cell: dict, data: dict, trace: bool, bench: dict, torch) -> dict:
    name = cell["name"]
    metrics = {}
    if trace:
        for m in common.cell_metrics(name, "per_layer", bench):
            value = common.layer_reader(m["name"]).read(data, cell)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
    else:
        for m in common.cell_metrics(name, "end_to_end", bench):
            if m["name"] in data["e2e"]:
                metrics[m["name"]] = common.metric(data["e2e"][m["name"]], m["unit"])
    on_card = torch.cuda.is_available()
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["workload"]["chips"],
              "memory_peak_bytes": int(data["memory_peak_bytes"])}
    line = {"attempted": data["attempted"], "failed": data["failed"], "metrics": metrics,
            "device": device}
    if trace and data["trace"]:
        device.update(busy_s=data["trace"]["busy_s"], window_s=data["trace"]["window_s"])
        line["breakdown"] = {"device_ops": data["trace"]["device_ops"],
                             "idle_gaps": data["trace"]["idle_gaps"]}
    line["card"] = common.card_identity()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_environment()
    try:
        cell = common.load_cell(args.workload)
        common.require_cards(cell["workload"]["chips"])
        line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except common.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    common.emit(line, checks)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """(result line, checks) of one run of ``cell``, after the card check."""
    import torch
    bench = common.manifest()
    traffic = common.traffic_module(cell["workload"]["generator"])
    data = traffic.run(cell, seed, seconds, trace, T_START, device=device,
                       on_card=device == "cuda")
    found = common.jax_modules()
    if found:
        raise common.BenchError(f"JAX modules loaded in the process: {found}")
    line = result_line(cell, data, trace, bench, torch)
    checks = checks_of(data["checks"], cell["workload"]["limits"], data["missing"])
    return {"correct": all(c["ok"] for c in checks), **line}, checks


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:   # any other failure: no result line, a non-zero exit
        traceback.print_exc()
        sys.exit(1)
