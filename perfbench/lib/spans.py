"""What the program's spans (``oryon_tpu_torch.utils.profiling.span``) give a
``torch.profiler`` window and a run: the window without the device's copies
of the spans, the kernel launches and host synchronisations of each span,
and the host time of each span.

A span is a ``record_function`` range.  With the card's activity traced,
the profiler also records a device-side copy of each range (flagged
``is_user_annotation``) over the kernels it launched; those copies are not
device work, and ``torch.autograd.profiler_util`` leaves them out of device
time too.  ``reduce`` leaves them out before ``trace.reduce`` forms the busy
union, the kernel table and the gaps, so the host-side ranges label the
gaps that open inside them.  Without spans in the window it is
``trace.reduce``.

A kernel that a CUDA graph runs has no launch call of its own: the
profiler records one ``cudaGraphLaunch`` for the graph and each kernel it
ran under that call's correlation id.  ``span_counts`` counts the graph
launches among the launch calls and the graph's kernels apart, so that
``launches_agree`` can hold the calls, each graph launch taken as the
kernels it ran, against the device's kernels."""
from __future__ import annotations

import bisect
from typing import Dict, List

from perfbench.lib import trace

ROOT = "engine.request"
GRAPH_LAUNCH = "cudaGraphLaunch"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            GRAPH_LAUNCH)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
NOT_KERNELS = ("Memcpy", "Memset")      # device events that are copies or fills
# The spans of a layer, by the start of their names (``layer_calls``)
FORWARD = ("pipeline.forward",)
SOLVERS = ("pipeline.solve", "solve.", "pointdsc.", "pipeline.icp", "icp.")


class _Events:
    """A profile's events, seen through a filter, as ``trace.reduce`` reads them."""

    def __init__(self, events: list):
        self._events = events

    def events(self) -> list:
        return self._events


def _on_device(e) -> bool:
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA


def without_annotations(prof) -> _Events:
    """The profile's events less the device-side copies of ranges."""
    return _Events([e for e in prof.events()
                    if not (_on_device(e) and getattr(e, "is_user_annotation", False))])


def reduce(prof, window_s: float, top: int = 10) -> Dict:
    """``trace.reduce`` of the profile without the device-side ranges."""
    return trace.reduce(without_annotations(prof), window_s, top)


def span_counts(prof) -> Dict:
    """Kernel-launch calls (graph launches among them) and host-blocking
    synchronisations of a profile with the host's activity, each counted
    once in the innermost span open when it starts ("host" when none is),
    and their totals under the ``engine.request`` spans: {"requests": the
    number of those spans, "request": {"launches", "syncs"} under them,
    "spans": {name: {"launches", "syncs"}}, "graph_launches": the graph
    launches under them, "kernels": the device's kernel events,
    "graph_kernels": those of them that a graph launch ran}."""
    spans, calls, kernel_ids, graph_ids = [], [], [], set()
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if _on_device(e):
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(NOT_KERNELS):
                kernel_ids.append(e.id)
        elif getattr(e, "is_user_annotation", False):
            spans.append((a, b, e.name))
        elif e.name in LAUNCHES or e.name in SYNCS:
            calls.append((a, "launches" if e.name in LAUNCHES else "syncs", e.name == GRAPH_LAUNCH))
            if e.name == GRAPH_LAUNCH:
                graph_ids.add(e.id)
    spans.sort()
    calls.sort()
    roots = [(a, b) for a, b, name in spans if name == ROOT]
    starts = [a for a, _ in roots]
    by_span: Dict[str, Dict[str, int]] = {}
    request = {"launches": 0, "syncs": 0}
    graph_launches = 0
    for (t, kind, graph), label in zip(calls, trace._label_gaps(spans, [c[0] for c in calls])):
        by_span.setdefault(label, {"launches": 0, "syncs": 0})[kind] += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= roots[i][1]:
            request[kind] += 1
            graph_launches += graph
    return {"requests": len(roots), "request": request, "spans": by_span,
            "graph_launches": graph_launches, "kernels": len(kernel_ids),
            "graph_kernels": sum(k in graph_ids for k in kernel_ids)}


def launches_agree(counts: Dict, share: float = 0.02) -> bool:
    """Whether the launch calls under the requests, each graph launch taken
    as the kernels it ran, meet the device's kernels within ``share`` of
    them: the check that the profile saw every launch (``span_counts``'s
    counts, totals or a request's)."""
    calls = counts["request"]["launches"] - counts["graph_launches"] + counts["graph_kernels"]
    return abs(calls - counts["kernels"]) <= share * max(counts["kernels"], 1)


def per_request(counts: Dict, records: List, counters: Dict[str, int]) -> Dict:
    """A traced run's span data a request: {"counts": ``span_counts``'s
    counts over its profiled requests, "timed_requests": the number of
    ``engine.request`` records, "ms": each span name's host ms over their
    requests, "counters": each counter over those requests}."""
    n = max(counts["requests"], 1)
    timed = sum(r.name == ROOT for r in records)
    m = max(timed, 1)
    return {"timed_requests": timed,
            "counts": {"requests": counts["requests"],
                       "request": {k: v / n for k, v in counts["request"].items()},
                       "spans": {s: {k: v / n for k, v in c.items()}
                                 for s, c in counts["spans"].items()},
                       **{k: counts[k] / n for k in ("graph_launches", "kernels",
                                                     "graph_kernels")}},
            "ms": {k: v["ms"] / m for k, v in span_ms(records).items()},
            "counters": {k: v / m for k, v in counters.items()}}


def layer_calls(data: Dict, kind: str, prefixes) -> float:
    """A request's ``kind`` ("launches" or "syncs") counted in the spans
    whose names start with any of ``prefixes`` (one layer's spans), from a
    traced run's ``data["spans"]``; None where the run has no spans, its
    profile saw no device kernel, none of those spans was open, or, for
    launches, the profile missed launches (``launches_agree``)."""
    s = data.get("spans")
    if not s or not s["counts"]["kernels"]:
        return None
    if kind == "launches" and not launches_agree(s["counts"]):
        return None
    found = [c[kind] for name, c in s["counts"]["spans"].items()
             if name.startswith(tuple(prefixes))]
    return sum(found) if found else None


def program_spans():
    """The program's span switch (``oryon_tpu_torch.utils.profiling``:
    ``set_spans``, ``take_spans``, ``take_counters``), or None where the
    program has none."""
    try:
        from oryon_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "set_spans") else None


def span_ms(records: List) -> Dict[str, Dict[str, float]]:
    """{name: {"calls", "ms"}}: the host time of each span name over the
    records (``SpanRecord``s of ``take_spans``)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        s = out.setdefault(r.name, {"calls": 0, "ms": 0.0})
        s["calls"] += 1
        s["ms"] += (r.t1_ns - r.t0_ns) * 1e-6
    return out
