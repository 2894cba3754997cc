"""``lib/spans.py`` on synthetic event lists, and ``perfbench/spans.py`` at a
tiny size on the CPU."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, device=False, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=CUDA if device else CPU, is_user_annotation=annotation)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_ranges_are_left_out_of_busy_kernels_and_gaps():
    """Two kernels 40 us apart under one span: the span's device copy
    would join them into one busy stretch; left out, the gap is there and
    the span open at its start names it."""
    prof = Prof([ev("engine.views", 0, 70, annotation=True),
                 ev("aten::mul", 2, 8),
                 ev("k_a", 0, 10, device=True), ev("k_b", 50, 60, device=True),
                 ev("engine.views", 0, 60, device=True, annotation=True)])
    seen = trace.reduce(prof, 1e-4)
    assert seen["busy_s"] == pytest.approx(60e-6) and seen["idle_gaps"] == []
    got = spans.reduce(prof, 1e-4)
    assert got["busy_s"] == pytest.approx(20e-6)
    assert set(got["kernels"]) == {"k_a", "k_b"}
    assert got["idle_gaps"] == [["engine.views", pytest.approx(40e-6)]]


def test_reduce_is_trace_reduce_without_ranges():
    events = [ev("aten::add", 0, 30), ev("cudaLaunchKernel", 3, 6),
              ev("aten::mm", 40, 90), ev("cudaStreamSynchronize", 60, 85),
              ev("k1", 5, 20, device=True), ev("k2", 35, 45, device=True),
              ev("k1", 70, 80, device=True), ev("Memcpy HtoD", 86, 88, device=True)]
    assert spans.reduce(Prof(events), 1e-4) == trace.reduce(Prof(events), 1e-4)


def test_each_call_counts_once_in_its_innermost_span():
    prof = Prof([ev("engine.request", 0, 100, annotation=True),
                 ev("pipeline.solve", 10, 50, annotation=True),
                 ev("pointdsc.seeds", 20, 30, annotation=True),
                 ev("cudaLaunchKernel", 5, 6), ev("cudaLaunchKernel", 15, 16),
                 ev("cuLaunchKernel", 25, 26), ev("cudaLaunchKernelExC", 27, 28),
                 ev("cudaStreamSynchronize", 40, 45), ev("cudaMemcpyAsync", 46, 47),
                 ev("cudaMemcpy", 60, 70),
                 ev("cudaLaunchKernel", 150, 151),          # after the request
                 ev("k", 10, 12, device=True), ev("k", 30, 32, device=True),
                 ev("k", 40, 42, device=True), ev("k", 50, 52, device=True),
                 ev("k", 160, 162, device=True),
                 ev("Memcpy DtoH", 70, 72, device=True),
                 ev("pipeline.solve", 15, 45, device=True, annotation=True)])
    got = spans.span_counts(prof)
    assert got["requests"] == 1 and got["kernels"] == 5
    assert got["request"] == {"launches": 4, "syncs": 2}
    assert got["spans"] == {"engine.request": {"launches": 1, "syncs": 1},
                            "pipeline.solve": {"launches": 1, "syncs": 1},
                            "pointdsc.seeds": {"launches": 2, "syncs": 0},
                            "host": {"launches": 1, "syncs": 0}}


def test_span_ms_sums_each_name():
    R = SimpleNamespace
    got = spans.span_ms([R(name="a", t0_ns=0, t1_ns=2_000_000),
                         R(name="a", t0_ns=5, t1_ns=1_000_005),
                         R(name="b", t0_ns=0, t1_ns=500_000)])
    assert got == {"a": {"calls": 2, "ms": pytest.approx(3.0)},
                   "b": {"calls": 1, "ms": pytest.approx(0.5)}}


@pytest.fixture
def tiny():
    from perfbench.tests.tiny import tiny_cell
    cell = tiny_cell("serve-bf16-b1")
    cell["config"]["pipeline"].update(icp_points=64, icp_iters=2)
    return cell


def test_script_measures_spans_at_a_tiny_size(tiny):
    from perfbench import spans as script
    out = script.measure(tiny, 2 ** 31 + 4243, 0.2, 1, device="cpu")
    assert out["spans"] and out["counts"]["requests"] == tiny["workload"]["label_requests"]
    assert out["syncs_per_request"] == 0 and out["launches_per_request"] == 0   # no card
    assert out["views_ms"] > 0 and out["span_ms_per_request"]["engine.request"] > out["views_ms"]
    assert out["counters_per_request"]["text_hit"] == 1
    assert out["turns"][0]["off"]["requests"] >= 1 and out["turns"][0]["on"]["requests"] >= 1


def test_script_times_a_program_without_spans(tiny, monkeypatch):
    from oryon_tpu_torch.utils import profiling

    from perfbench import spans as script
    monkeypatch.delattr(profiling, "set_spans")
    out = script.measure(tiny, 2 ** 31 + 4243, 0.2, 1, device="cpu")
    assert not out["spans"] and "counts" not in out and list(out["turns"][0]) == ["off"]
