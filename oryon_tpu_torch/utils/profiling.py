"""Profiling hooks on ``torch.profiler``: the step window and named spans.

``StepProfiler``, the counterpart of the one in ``oryon_tpu/utils/profiling.py``,
records one window of steps of an entry point's loop (``cfg.profiler``),
late enough to skip the first kernel builds and warm-up, and writes a
Chrome trace and a table of time by kernel into ``logdir``.

Spans name the host's work at the serving path's layer boundaries
(``infer.OryonPredictor.predict``, ``pipeline.make_run_fn``, PointDSC):
``with span("engine.views"): ...``.  They are off unless ``set_spans(True)``
(or a ``StepProfiler`` window) turns them on; off, ``span`` is one flag test
that returns a shared no-op object.  On, a span opens a
``torch.profiler.record_function`` range of its name, so that any active
profile shows it on its own clock, and when it closes stores a
``SpanRecord`` stamped by ``time.time_ns``, the clock that
``torch.profiler`` stamps its events by.  The outermost open span of a thread
starts a request: it and every span opened inside it carry its id.
``count(name, n)`` adds to a named counter while spans are on.
``take_spans()`` and ``take_counters()`` hand over what was stored and clear
it.  One serving thread opens spans at a time; each thread keeps its own
stack of open spans.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    request: int            # id of the outermost span this one lies in
    name: str
    parent: Optional[str]   # the span open around it, None for the outermost
    t0_ns: int              # time.time_ns() after the profiler range opened
    t1_ns: int              # time.time_ns() before it closed


_spans_on = False
_records: List[SpanRecord] = []
_counters: Dict[str, int] = {}
_open = threading.local()       # .stack: the thread's open spans, innermost last
_next_request = 0


class _NoSpan:
    """What ``span`` returns while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "request", "t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_request
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1].name, stack[-1].request
        else:
            self.parent, self.request = None, _next_request
            _next_request += 1
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _records.append(SpanRecord(self.request, self.name, self.parent, self.t0, t1))
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A context manager over the host's work named ``name``: a shared no-op
    while spans are off, a recorded span while they are on."""
    return _Span(name) if _spans_on else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    if _spans_on:
        _counters[name] = _counters.get(name, 0) + n


def set_spans(on: bool) -> bool:
    """Turn spans on or off; returns whether they were on."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    if _spans_on and not was:
        # the first range of a process builds its operator (about 1 ms):
        # build it here, outside any span
        with torch.profiler.record_function("spans.on"):
            pass
    return was


def take_spans() -> List[SpanRecord]:
    """The spans closed since the last call, in closing order."""
    global _records
    out, _records = _records, []
    return out


def take_counters() -> Dict[str, int]:
    """The counters since the last call."""
    global _counters
    out, _counters = _counters, {}
    return out


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
    ``step()`` is one integer compare when disabled.  Spans are on for the
    window, so that its trace names them, and as they were after it."""

    def __init__(self, enabled: bool, logdir: Optional[str], start: int = 10,
                 n_steps: int = 5):
        self.enabled = bool(enabled) and logdir is not None
        self.logdir = logdir
        self.start = start
        self.stop = start + n_steps
        self.n_steps = n_steps
        self._i = 0
        self._prof = None
        self._spans_were = False

    def step(self) -> None:
        """Call once per dispatched step."""
        if not self.enabled:
            return
        if self._i == self.start:
            self._spans_were = set_spans(True)
            self._prof = torch.profiler.profile(activities=activities())
            self._prof.__enter__()
        elif self._i == self.stop:
            self._finish()
        self._i += 1

    def _finish(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            set_spans(self._spans_were)
            self._prof.__exit__(None, None, None)
            if not self._spans_were:    # the window's records have no other reader
                take_spans()
                take_counters()
            path = write_trace(self._prof, self.logdir, "steps")
            self._prof = None
            self.enabled = False
            print(f"profiler: wrote a {self.n_steps}-step trace to {self.logdir} "
                  f"(table {path})")

    def close(self) -> None:
        """Flush an unfinished window (short runs)."""
        self._finish()
