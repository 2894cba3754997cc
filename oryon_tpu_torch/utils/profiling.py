"""Profiling hook on ``torch.profiler``, gated by the config flag.

Counterpart of ``StepProfiler`` in ``oryon_tpu/utils/profiling.py``: it
records one window of steps of an entry point's loop (``cfg.profiler``),
late enough to skip the first kernel builds and warm-up, and writes a
Chrome trace and a table of time by kernel into ``logdir``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def activities():
    """CPU, and CUDA where there is a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def write_trace(prof, logdir: str, name: str) -> str:
    """``<logdir>/<name>.json`` (Chrome trace) and ``<name>.txt`` (the 40
    operations that took the most self time, device time on a card);
    returns the table's path."""
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))
    key = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=key, row_limit=40)
    path = os.path.join(logdir, f"{name}.txt")
    with open(path, "w") as f:
        f.write(table)
    return path


class StepProfiler:
    """One profiled window over steps [start, start + n_steps) of a loop;
    ``step()`` is one integer compare when disabled."""

    def __init__(self, enabled: bool, logdir: Optional[str], start: int = 10,
                 n_steps: int = 5):
        self.enabled = bool(enabled) and logdir is not None
        self.logdir = logdir
        self.start = start
        self.stop = start + n_steps
        self.n_steps = n_steps
        self._i = 0
        self._prof = None

    def step(self) -> None:
        """Call once per dispatched step."""
        if not self.enabled:
            return
        if self._i == self.start:
            self._prof = torch.profiler.profile(activities=activities())
            self._prof.__enter__()
        elif self._i == self.stop:
            self._finish()
        self._i += 1

    def _finish(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            path = write_trace(self._prof, self.logdir, "steps")
            self._prof = None
            self.enabled = False
            print(f"profiler: wrote a {self.n_steps}-step trace to {self.logdir} "
                  f"(table {path})")

    def close(self) -> None:
        """Flush an unfinished window (short runs)."""
        self._finish()
