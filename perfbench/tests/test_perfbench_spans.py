"""``lib/spans.py`` on synthetic event lists, the launch reader's check,
the spans of a traced run, and ``perfbench/spans.py`` at a tiny size on the
CPU."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, device=False, annotation=False, cid=0):
    """An event as ``prof.events()`` gives it; ``cid``: the correlation id,
    which a launch call and the kernels it ran share."""
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=CUDA if device else CPU, is_user_annotation=annotation,
                           id=cid)


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


def _graph_profile(calls_missing=0, graph_ids_match=True):
    """One request: 50 kernels launched one by one in the forward and one
    graph launch in ICP that ran 50 more (sharing its correlation id unless
    ``graph_ids_match`` is false); ``calls_missing`` of the single launch
    calls not recorded."""
    events = [ev("engine.request", 0, 1000, annotation=True),
              ev("pipeline.forward", 0, 500, annotation=True),
              ev("icp.iterate", 800, 900, annotation=True),
              ev("cudaGraphLaunch", 810, 820, cid=999),
              ev("cudaStreamSynchronize", 880, 890, cid=1000)]
    for i in range(50):
        if i >= calls_missing:
            events.append(ev("cudaLaunchKernel", 10 * i, 10 * i + 2, cid=i + 1))
        events.append(ev("k", 10 * i + 3, 10 * i + 5, device=True, cid=i + 1))
        events.append(ev("g", 820 + i, 820.5 + i, device=True,
                         cid=999 if graph_ids_match else 2000 + i))
    return Prof(events)


def test_graph_launches_count_as_calls_and_their_kernels_apart():
    got = spans.span_counts(_graph_profile())
    assert got["request"] == {"launches": 51, "syncs": 1}
    assert got["spans"]["icp.iterate"] == {"launches": 1, "syncs": 1}
    assert (got["graph_launches"], got["graph_kernels"], got["kernels"]) == (1, 50, 100)
    assert spans.launches_agree(got)


@pytest.mark.parametrize("missing, graph_ids_match, agree", [
    (0, True, True), (1, True, True),   # one launch in 100 lost: within 2%
    (3, True, False),                   # three lost: no reading
    (0, False, False),                  # the graph's kernels not matched to their launch
])
@pytest.mark.parametrize("reader, syncs, full, lost_here", [
    ("launches.serve", "syncs.serve", 51, True), ("launches.tail", "syncs.tail", 51, True),
    ("forward_launches.serve", None, 50, True), ("forward_launches.tail", None, 50, True),
    ("solver_launches.serve", "solver_syncs.serve", 1, False),
    ("solver_launches.tail", "solver_syncs.tail", 1, False)])
def test_launch_reader_reads_nothing_beyond_two_percent(reader, syncs, full, lost_here, missing,
                                                        graph_ids_match, agree):
    """The request's launch calls, or one layer's (the forward's: the 50
    single launches; the solvers': ICP's one graph launch), where the
    profile saw every launch but 2%; the syncs (ICP's one) either way."""
    from perfbench.lib.common import layer_reader
    counts = spans.span_counts(_graph_profile(missing, graph_ids_match))
    data = {"spans": spans.per_request(counts, [], {})}
    want = full - missing if lost_here else full
    assert layer_reader(reader).read(data, None) == (want if agree else None)
    if syncs:
        assert layer_reader(syncs).read(data, None) == 1


def test_layer_readers_read_nothing_without_their_spans():
    """A profile in which no span of the layer was open reads nothing, not 0."""
    from perfbench.lib.common import layer_reader
    prof = _graph_profile()
    prof._events = [e for e in prof._events if e.name != "pipeline.forward"]
    data = {"spans": spans.per_request(spans.span_counts(prof), [], {})}
    assert layer_reader("forward_launches.serve").read(data, None) is None
    assert layer_reader("solver_launches.serve").read(data, None) == 1


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


@pytest.mark.parametrize("has_spans", [True, False])
def test_a_traced_run_hands_the_spans_to_the_readers(tiny, monkeypatch, has_spans):
    """Spans on for the labelled profile and through the window, whose
    requests give the host ms and the counters; off again after it; a
    program without spans gives none."""
    import time

    from oryon_tpu_torch.utils import profiling

    from perfbench.lib.common import layer_reader
    from perfbench.traffic import serve_closed
    if not has_spans:
        monkeypatch.delattr(profiling, "set_spans")
    data = serve_closed.run(tiny, 2 ** 31 + 4244, 0.3, True, time.perf_counter(), device="cpu",
                            on_card=False)
    views = layer_reader("views_ms.serve").read(data, tiny)
    if not has_spans:
        assert data["spans"] is None and views is None
        return
    assert not profiling.set_spans(False)           # off after the window
    s = data["spans"]
    assert s["counts"]["requests"] == tiny["workload"]["label_requests"]
    assert s["timed_requests"] == data["requests"] >= 1
    assert views == s["ms"]["engine.views"] > 0
    assert s["ms"]["engine.request"] > views
    assert s["counters"]["text_hit"] == 1
    for name in ("launches.serve", "syncs.serve", "launches.tail", "syncs.tail",
                 "forward_launches.serve", "solver_launches.serve", "solver_syncs.serve"):
        assert layer_reader(name).read(data, tiny) is None      # no card: nothing to read
