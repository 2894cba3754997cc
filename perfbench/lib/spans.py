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
``trace.reduce``."""
from __future__ import annotations

import bisect
from typing import Dict, List

from perfbench.lib import trace

ROOT = "engine.request"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
NOT_KERNELS = ("Memcpy", "Memset")      # device events that are copies or fills


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
    """Kernel-launch calls and host-blocking synchronisations of a profile
    with the host's activity, each counted once in the innermost span open
    when it starts ("host" when none is), and their totals under the
    ``engine.request`` spans: {"requests": the number of those spans,
    "request": {"launches", "syncs"} under them, "spans": {name:
    {"launches", "syncs"}}, "kernels": the device's kernel events}."""
    spans, calls, kernels = [], [], 0
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if _on_device(e):
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(NOT_KERNELS):
                kernels += 1
        elif getattr(e, "is_user_annotation", False):
            spans.append((a, b, e.name))
        elif e.name in LAUNCHES or e.name in SYNCS:
            calls.append((a, "launches" if e.name in LAUNCHES else "syncs"))
    spans.sort()
    calls.sort()
    roots = [(a, b) for a, b, name in spans if name == ROOT]
    starts = [a for a, _ in roots]
    by_span: Dict[str, Dict[str, int]] = {}
    request = {"launches": 0, "syncs": 0}
    for (t, kind), label in zip(calls, trace._label_gaps(spans, [t for t, _ in calls])):
        by_span.setdefault(label, {"launches": 0, "syncs": 0})[kind] += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= roots[i][1]:
            request[kind] += 1
    return {"requests": len(roots), "request": request, "spans": by_span, "kernels": kernels}


def span_ms(records: List) -> Dict[str, Dict[str, float]]:
    """{name: {"calls", "ms"}}: the host time of each span name over the
    records (``SpanRecord``s of ``take_spans``)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        s = out.setdefault(r.name, {"calls": 0, "ms": 0.0})
        s["calls"] += 1
        s["ms"] += (r.t1_ns - r.t0_ns) * 1e-6
    return out
