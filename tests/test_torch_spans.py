"""Named host spans on the serving path (``oryon_tpu_torch.utils.profiling``):
off by default and then a shared no-op; on, one ``engine.request`` a chunk
with the engine's, the pipeline's and PointDSC's spans nested inside, the
same names in a ``torch.profiler`` profile on the same clock, and the
pipeline's ``stage_events`` as before.  Tiny sizes on the CPU."""
import json
import statistics

import numpy as np
import pytest
import torch

from oryon_tpu_torch.utils import profiling

IMG, DEPTH_HW, MAXC = 56, (48, 64), 32

# every span of a request, in the order they open, with its parent
REQUEST_SPANS = [
    ("engine.request", None),
    ("engine.text", "engine.request"),
    ("engine.views", "engine.request"),
    ("pipeline.forward", "engine.request"),
    ("pipeline.match", "engine.request"),
    ("pipeline.solve", "engine.request"),
    ("solve.lift", "pipeline.solve"),
    ("pointdsc.encoder", "pipeline.solve"),
    ("pointdsc.seeds", "pipeline.solve"),
    ("pointdsc.refine", "pipeline.solve"),
    ("pipeline.icp", "engine.request"),
    ("icp.clouds", "pipeline.icp"),
    ("icp.iterate", "pipeline.icp"),
    ("pipeline.pack", "engine.request"),
    ("engine.fetch", "engine.request"),
]


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and nothing stored."""
    profiling.set_spans(False)
    profiling.take_spans()
    profiling.take_counters()
    yield
    profiling.set_spans(False)
    profiling.take_spans()
    profiling.take_counters()


def _fake_tokenize(prompt: str) -> np.ndarray:
    ids = np.zeros((8, 16), np.int32)      # tiny_oryon: 8 prompts, 16 tokens, 600 ids
    ids[:, 0], ids[:, 1], ids[:, 2] = 598, len(prompt) % 500 + 1, 599
    return ids


@pytest.fixture(scope="module")
def predictor():
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig

    g = torch.Generator().manual_seed(0)
    return OryonPredictor(random_init_(tiny_oryon(), g),
                          random_init_(PointDSC(PointDSCConfig(num_layers=2)), g),
                          device="cpu", batch_size=2, img_size=(IMG, IMG),
                          depth_hw=DEPTH_HW, solver="pointdsc", n_corrs=MAXC,
                          tokenize_fn=_fake_tokenize, icp_refine=True, icp_points=64,
                          icp_iters=2)


def _requests(prompts, seed=1):
    rs = np.random.RandomState(seed)

    def view():
        return {"rgb": (rs.rand(64, 64, 3) * 255).astype(np.uint8),
                "depth": (rs.rand(*DEPTH_HW) * 300 + 600).astype(np.float32),
                "camera": [60.0, 60.0, 32.0, 24.0]}

    return [{"anchor": view(), "query": view(), "prompt": p} for p in prompts]


class _Event:
    """``torch.cuda.Event`` on a host without a card."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass


def test_spans_off_are_one_shared_noop():
    """Off: every name gives the same object, and nothing is stored."""
    a, b = profiling.span("engine.request"), profiling.span("pipeline.solve")
    assert a is b
    with a, b:
        profiling.count("text_hit")
    assert profiling.take_spans() == [] and profiling.take_counters() == {}
    assert profiling.set_spans(True) is False
    assert profiling.span("x") is not a
    assert profiling.set_spans(False) is True


def test_predictor_spans_nest_per_request(predictor):
    """One ``engine.request`` a chunk (three requests at batch 2: two
    chunks, the second padded), each holding every span of the path in
    order under its parent, inside its parent's interval, with one request
    id; the counters see two new prompts, two cached, one pad and the two
    chunks' ICP calls on the eager loop (the CPU's)."""
    predictor._text_cache.clear()
    profiling.set_spans(True)
    predictor.predict(_requests(["mug", "bottle", "mug"]))
    profiling.set_spans(False)
    records = profiling.take_spans()
    assert profiling.take_counters() == {"text_miss": 2, "text_hit": 2, "padded_pairs": 1,
                                         "icp_eager": 2}

    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["engine.request"] * 2
    assert roots[0].request != roots[1].request
    for root in roots:
        mine = sorted((r for r in records if r.request == root.request), key=lambda r: r.t0_ns)
        assert [(r.name, r.parent) for r in mine] == REQUEST_SPANS
        by_name = {r.name: r for r in mine}
        for r in mine[1:]:
            outer = by_name[r.parent]
            assert outer.t0_ns <= r.t0_ns <= r.t1_ns <= outer.t1_ns
    assert roots[0].t1_ns <= roots[1].t0_ns


def test_spans_are_in_the_profile_on_its_clock(predictor):
    """The spans are ``record_function`` events of a CPU profile, on the
    clock their records are stamped by: each stored span lies inside its
    event, and the stamps lie within 50 us of the event's ends (the median
    over every span: a stall of the host between the two stamps, which
    another process can cause, moves single spans by milliseconds)."""
    predictor.predict(_requests(["mug", "bottle"]))         # text cached, warm
    profiling.set_spans(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        predictor.predict(_requests(["mug", "bottle", "bottle", "mug"], seed=2))
    profiling.set_spans(False)
    records = profiling.take_spans()
    names = {n for n, _ in REQUEST_SPANS}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            assert e.is_user_annotation()
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert set(events) == names
    offsets = []
    for name in names:
        mine = sorted((r.t0_ns, r.t1_ns) for r in records if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 2
        for (t0, t1), (e0, e1) in zip(mine, theirs):
            assert e0 <= t0 <= t1 <= e1
            offsets += [(t0 - e0) / 1e3, (e1 - t1) / 1e3]
    assert statistics.median(offsets) < 50.0


@pytest.mark.parametrize("spans_on", [False, True])
def test_stage_events_unchanged(predictor, monkeypatch, spans_on):
    """``stage_events`` holds the same (name, event) pairs in the same
    order with spans off and on."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    profiling.set_spans(spans_on)
    events = []
    predictor.predict(_requests(["mug", "bottle"]), stage_events=events)
    assert [n for n, _ in events] == ["start", "forward", "match", "solve", "icp", "end"]
    assert all(isinstance(ev, _Event) for _, ev in events)


@pytest.mark.parametrize("spans_before", [False, True])
def test_step_profiler_turns_spans_on_for_its_window(tmp_path, spans_before):
    """Spans are on from the window's first step to its last, its trace
    names them, and afterwards they are as they were (and the window's
    records are dropped when nothing else had turned spans on)."""
    profiling.set_spans(spans_before)
    sp = profiling.StepProfiler(True, str(tmp_path), start=1, n_steps=2)
    on = []
    for _ in range(5):
        on.append(profiling.span("step") is not profiling.span("other"))
        with profiling.span("engine.request"):
            torch.ones(8).sum()
        sp.step()
    sp.close()
    assert on == [spans_before, spans_before, True, True, spans_before]
    assert (profiling.span("a") is not profiling.span("b")) == spans_before
    kept = [r.name for r in profiling.take_spans()]
    assert kept == (["engine.request"] * 5 if spans_before else [])
    with open(tmp_path / "steps.json") as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("engine.request") == 2
