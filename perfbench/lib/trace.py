"""Reduction of a ``torch.profiler`` window to what the readers take: the
device's busy seconds (the union of every device operation's interval), the
kernels by name, the operations that took most device time and the longest
idle gaps by what the host was doing."""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label_gaps(cpu: List[Tuple[float, float, str]], starts: List[float]) -> List[str]:
    """For each gap start (ascending), the innermost host operation running
    then: the latest-started one that spans it, or "host" when none is
    recorded.  ``cpu`` is sorted by start."""
    labels, i, open_ = [], 0, []
    for t in starts:
        while i < len(cpu) and cpu[i][0] <= t:
            heapq.heappush(open_, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while open_ and open_[0][1] < t:    # ended: t only grows
            heapq.heappop(open_)
        labels.append(open_[0][2] if open_ else "host")
    return labels


def reduce(prof, window_s: float, top: int = 10) -> Dict:
    """{busy_s, window_s, kernels {name: [count, seconds]}, device_ops
    [[name, seconds]], idle_gaps [[host op, seconds]]} of one profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end     # microseconds
        if e.device_type == cuda:
            dev.append((a, b, e.name))
        else:
            cpu.append((a, b, e.name))
    kernels: Dict[str, List[float]] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _ in dev])
    gaps: Dict[str, float] = {}
    cpu.sort()
    pairs = list(zip(busy, busy[1:]))
    for ((_, b0), (a1, _)), label in zip(pairs, _label_gaps(cpu, [b0 for (_, b0), _ in pairs])):
        gaps[label] = gaps.get(label, 0.0) + (a1 - b0) * 1e-6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": window_s,
            "kernels": kernels,
            "device_ops": [[n, s] for n, (_, s) in ranked],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def kernel_stats(kernels: Dict[str, List[float]], patterns) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds any of ``patterns``."""
    n, s = 0, 0.0
    for name, (c, t) in kernels.items():
        if any(p in name for p in patterns):
            n, s = n + c, s + t
    return n, s
