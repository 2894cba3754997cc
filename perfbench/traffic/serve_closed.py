"""Closed-loop serving traffic: one client sends a request of ``batch``
pairs to ``OryonPredictor.predict`` and sends the next when the answers are
on the host.

The traffic mix's file gives the batch, the frame size, the pool of view
pairs generated at set-up from the seed, the prompts and the requests
warmed up and profiled in a traced run; the cell's file the sample checked
after the window and its limits; the configuration the pipeline's settings
and its model reference (``lib/common.reference``).  Every seed gives the
same sizes: requests of ``batch`` pairs drawn from a pool of
``pool_pairs``, so a seed changes the views and their order, not the
work's shape.

``run`` returns the run's data: end-to-end numbers, per-request host times
and stage events (traced runs), the profile's reduction, the launch counts
over the profiled requests, the program's spans and counters a request
under ``spans`` (traced runs: launch calls and syncs from the labelled
profile, host ms and counters over the window's requests) and the
comparison's numbers.
"""
from __future__ import annotations

import random
import statistics
import sys
import time
from typing import Dict

import numpy as np

from perfbench.lib import common, serve_check, spans as spans_lib, weights
from perfbench.reference import pose as ref_pose
from perfbench.traffic.views import REAL275_K, view_pair


def tokenizer(cfg: dict):
    """Prompt -> [P, L] token ids: for template t, start, the bytes of
    "t: prompt" as ids 1-256, end (the highest id, where the text tower
    pools).  Made by the benchmark and handed to both sides."""
    text = cfg["model"]["text"]
    P, L, V = cfg["model"]["fusion"]["num_prompts"], text["context_length"], text["vocab_size"]

    def tokenize(prompt: str) -> np.ndarray:
        ids = np.zeros((P, L), np.int64)
        for t in range(P):
            body = [1 + b for b in f"{t}: {prompt}".encode()][:L - 2]
            ids[t, :len(body) + 2] = [V - 2] + body + [V - 1]
        return ids

    return tokenize


def make_requests(wl: dict, seed: int):
    """(warm-up requests, a function that draws the next timed request),
    both from the seed.  The pool's pairs take the prompts in turn, and the
    warm-up sends the pool in order, so that it meets every prompt before
    the window; each timed request is ``batch`` pairs drawn from the pool."""
    rs = np.random.RandomState(seed % 2 ** 32)
    hw = tuple(wl["frame_hw"])
    pool = []
    for k in range(wl["pool_pairs"]):
        v = view_pair(rs, hw)
        prompt = wl["prompts"][k % len(wl["prompts"])]
        pool.append({"anchor": {"rgb": v["rgb_a"], "depth": v["depth_a"], "camera": REAL275_K},
                     "query": {"rgb": v["rgb_q"], "depth": v["depth_q"], "camera": REAL275_K},
                     "prompt": prompt})
    B = wl["batch"]
    warm = [[pool[(k * B + j) % len(pool)] for j in range(B)]
            for k in range(-(-len(wl["prompts"]) // B) + wl["warmup_requests"])]
    order = random.Random(seed)

    def next_request():
        return [pool[order.randrange(len(pool))] for _ in range(B)]

    return warm, next_request


def build_program(cfg: dict, state: dict, pdsc_state: dict, wl: dict, device, noise_seed: int):
    """The served engine of the configuration, holding the benchmark's weights."""
    import torch
    from oryon_tpu_torch.infer import OryonPredictor
    from oryon_tpu_torch.models.clip import ClipTextConfig, ClipVisionConfig
    from oryon_tpu_torch.models.decoder import DecoderConfig
    from oryon_tpu_torch.models.fusion import FusionConfig
    from oryon_tpu_torch.models.oryon import OryonModel
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.models.swin import SwinConfig

    m, pipe = cfg["model"], cfg["pipeline"]
    sw = dict(m["swin"], depths=tuple(m["swin"]["depths"]), heads=tuple(m["swin"]["heads"]),
              attn_impl=m["swin_attn_impl"])
    dec = {k: tuple(v) for k, v in m["decoder"].items() if k != "input_dim"}
    with torch.device(device):
        model = OryonModel(
            fusion_cfg=FusionConfig(**m["fusion"]),
            decoder_cfg=DecoderConfig(input_dim=m["decoder"]["input_dim"], **dec),
            vision_cfg=ClipVisionConfig(**m["vision"], attn_impl=m["attn_impl"], quant=m["quant"]),
            text_cfg=ClipTextConfig(**m["text"]), swin_cfg=SwinConfig(**sw),
            swin_image_size=m["swin_image_size"], dtype=getattr(torch, m["dtype"]))
        pdsc = PointDSC(PointDSCConfig(**cfg["pointdsc"]))
    model.load_state_dict(state, strict=True)
    pdsc.load_state_dict(pdsc_state, strict=True)
    return OryonPredictor(
        model, pdsc, device=device, batch_size=wl["batch"], img_size=tuple(m["image_hw"]),
        depth_hw=tuple(wl["frame_hw"]), solver=pipe["solver"], n_corrs=pipe["n_corrs"],
        dist_th=pipe["dist_th"], mask_threshold=pipe["mask_threshold"], seed=noise_seed,
        tokenize_fn=tokenizer(cfg), icp_refine=pipe["icp_refine"],
        icp_points=pipe["icp_points"], icp_iters=pipe["icp_iters"], icp_trim=pipe["icp_trim"])


class Capture:
    """Hooks on the engine that keep what the timed path produced for the
    requests being captured: the model's inputs and outputs, PointDSC's
    pose and the pipeline's outputs.  Idle, a hook is one attribute test."""

    def __init__(self, predictor):
        self.on, self.cur = False, {}
        predictor.model.register_forward_hook(self._model)
        predictor.model.vlm_visual.register_forward_hook(self._keep("visual"))
        predictor.model.guidance.register_forward_hook(self._keep("guid"))
        predictor.pointdsc.register_forward_hook(self._pointdsc)
        run = predictor._run

        def wrapped(*args, **kw):
            out = run(*args, **kw)
            if self.on:
                self.cur.update(corrs=out.corrs, corr_valid=out.corr_valid, pose=out.pred_rel_pose,
                                out_mask_a=out.mask_a, out_mask_q=out.mask_q)
            return out

        predictor._run = wrapped

    def _keep(self, key):
        def hook(mod, args, out):
            if self.on:
                self.cur[key] = out
        return hook

    def _model(self, mod, args, out):
        if self.on:
            self.cur.update(rgb_a=args[0], rgb_q=args[1], text=args[3], featmap_a=out.featmap_a,
                            featmap_q=out.featmap_q, mask_a=out.mask_a, mask_q=out.mask_q)

    def _pointdsc(self, mod, args, out):
        if self.on:
            self.cur.update(pointdsc_T=out[0], pointdsc_conf=out[2])

    def take(self) -> Dict:
        cur, self.cur = self.cur, {}
        return cur


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        on_card: bool = True, keep: bool = False) -> Dict:
    """One run: set-up, warm-up, ``seconds`` of closed-loop requests, then
    the comparison of the sampled requests.  ``keep``: the samples, the
    prompt tokenizer and the engine's noise seed stay in the returned data
    (for the control's readings)."""
    import torch
    wl, cfg = cell["workload"], cell["config"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        spec = common.reference(cfg).Oryon(cfg)
        pspec = ref_pose.PointDSC(cfg["pointdsc"])
    state = weights.make_state(spec, gen, dev)
    pdsc_state = weights.make_state(pspec, gen, dev)
    noise_seed = seed + 1
    predictor = build_program(cfg, state, pdsc_state, wl, dev, noise_seed)
    del state, pdsc_state
    warm, next_request = make_requests(wl, seed)
    capture = Capture(predictor)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    calls = 0       # predict calls so far: each draws one request's noise

    def serve(reqs, events=None):
        nonlocal calls
        calls += 1
        return predictor.predict(reqs, stage_events=events)

    for r in warm:      # kernels built, every prompt's text cached, shapes met
        serve(r)
    sync()
    check_at = set(random.Random(seed ^ 0x5EED).sample(range(wl["check_within"]),
                                                       wl["check_requests"]))
    setup_s = time.perf_counter() - t_start
    trace_data, launches, k2_work, counts = None, None, [], None
    profiling = spans_lib.program_spans() if trace else None
    if trace:
        trace_data, launches, k2_work, counts = profile(wl, cfg, next_request, serve, capture,
                                                        sync, on_card, profiling)
    # the window: the requests after the profiled ones
    samples, lat, host_ms, stage_ms = [], [], [], []
    need = wl["check_within"] if keep else 0     # the control's runs answer the whole sample
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds or i < need:
        reqs = next_request()
        events = [] if trace and on_card else None
        capture.on = i in check_at
        draw = calls
        t1 = time.perf_counter()
        serve(reqs, events)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        if capture.on:
            samples.append(dict(capture.take(), index=i, draw=draw, requests=reqs))
            capture.on = False
        if events is not None:
            marks = dict(events)
            host_ms.append((t2 - t1) * 1e3 - marks["start"].elapsed_time(marks["end"]))
            stage_ms.append({"forward": marks["start"].elapsed_time(marks["forward"]),
                             "pose": marks["match"].elapsed_time(marks["icp"])})
        i += 1
    t_end = time.perf_counter()
    n_req = i
    spans = None
    if profiling:       # on since the labelled profile: the window's spans
        spans = spans_lib.per_request(counts, profiling.take_spans(), profiling.take_counters())
        profiling.set_spans(False)
    if trace_data:
        per = trace_data["request_s"]
        print(f"perfbench: a profiled request took {per['card_only'] * 1e3:.1f} ms with the "
              f"card's activity traced, {per['with_host'] * 1e3:.1f} ms with the host's too; "
              f"a window's request {statistics.fmean(lat) * 1e3:.1f} ms", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    missing = sorted(check_at - {s["index"] for s in samples})

    # the window has closed: free the program, then the reference
    del predictor, capture
    if on_card:
        torch.cuda.empty_cache()
    tokenize = tokenizer(cfg)
    checks = compare(cfg, wl, samples, seed, noise_seed, tokenize, dev) if samples else {}

    pairs = wl["batch"] * n_req
    window = t_end - t0
    e2e = {"serve_pairs_per_s": pairs / window, "setup_s": setup_s}
    if len(lat) >= 20:
        e2e["serve_p95_ms"] = statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
    kept = {"samples": samples, "tokenize": tokenize, "noise_seed": noise_seed} if keep else {}
    return {**kept, "e2e": e2e, "requests": n_req, "pairs": pairs, "window_s": window,
            "latency_s": lat, "host_ms": host_ms, "stage_ms": stage_ms, "trace": trace_data,
            "launches": launches, "k2_work": k2_work, "spans": spans,
            "memory_peak_bytes": peak, "checks": checks, "missing": missing,
            "attempted": n_req, "failed": 0}


def profile(wl, cfg, next_request, serve, capture, sync, on_card, profiling=None):
    """The profiled requests of a traced run, before its window.  The first
    ``trace_requests`` are traced with the card's activity alone and the
    program's spans off, which leaves the host's dispatch nearly as fast as
    unprofiled: they give the busy seconds and the window, the kernels, the
    port's launch counts over the same requests and the matching work each
    needed (valid sources x kept targets).  Then, where the program has
    spans (``profiling``, ``lib/spans.program_spans``), they are turned on:
    the next ``label_requests`` are traced with the host's operations too,
    which slows the dispatch; they label the idle gaps by the span or
    operation open at their start and give the launch calls and host syncs
    of each span.  Their span records and counters are dropped, and spans
    stay on for the window, whose requests give each span's host time and
    the counters (a span costs some 15 us on).  Returns (device, launches,
    work, counts): ``counts`` is ``lib/spans.span_counts``'s, None where the
    program has no spans; ``device["labelled"]`` the labelled profile's
    busy, idle and unlabelled ("host") seconds."""
    import torch
    from oryon_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    from perfbench.lib import trace as trace_lib

    acts = torch.profiler.ProfilerActivity
    masks = []
    reset_launch_counts()
    with torch.profiler.profile(activities=[acts.CUDA] if on_card else [acts.CPU]) as prof:
        ta = time.perf_counter()
        for _ in range(wl["trace_requests"]):
            capture.on = True
            serve(next_request())
            cur = capture.take()
            masks.append((cur["out_mask_a"], cur["out_mask_q"]))
        capture.on = False
        sync()
        tb = time.perf_counter()
    launches = launch_counts()
    device = trace_lib.reduce(prof, tb - ta)
    if profiling:
        profiling.set_spans(True)
    with torch.profiler.profile(activities=[acts.CPU] + ([acts.CUDA] if on_card else [])) as prof:
        tc = time.perf_counter()
        for _ in range(wl["label_requests"]):
            serve(next_request())
        sync()
        td = time.perf_counter()
    labelled = spans_lib.reduce(prof, td - tc, top=10 ** 6)
    gaps = labelled["idle_gaps"]
    device["idle_gaps"] = gaps[:10]
    device["labelled"] = {"window_s": td - tc, "busy_s": labelled["busy_s"],
                          "idle_s": sum(s for _, s in gaps), "host_s": dict(gaps).get("host", 0.0)}
    device["request_s"] = {"card_only": (tb - ta) / wl["trace_requests"],
                           "with_host": (td - tc) / wl["label_requests"]}
    counts = None
    if profiling:
        counts = spans_lib.span_counts(prof)
        profiling.take_spans()
        profiling.take_counters()
    cap = cfg["pipeline"]["src_capacity"]
    work = [int((torch.clamp(a.flatten(1).sum(-1), max=cap).double()
                 * b.flatten(1).sum(-1).double()).sum()) for a, b in masks]
    return device, launches, work, counts


def compare(cfg, wl, samples, seed, noise_seed, tokenize, dev) -> Dict:
    """The comparison's numbers: each one's worst over the sample."""
    import torch
    spec_gen = torch.Generator(device=dev).manual_seed(seed)
    ref = common.reference(cfg).build(cfg, dev)
    ref.load_state_dict(weights.make_state(ref, spec_gen, dev), strict=True)
    pdsc = ref_pose.build_pointdsc(cfg, dev)
    pdsc.load_state_dict(weights.make_state(pdsc, spec_gen, dev), strict=True)
    pipe, m = cfg["pipeline"], cfg["model"]
    readings = []
    for s in sorted(samples, key=lambda s: s["draw"]):
        reqs = s["requests"]
        ids = torch.as_tensor(np.stack([tokenize(r["prompt"]) for r in reqs]), device=dev)
        numbers = serve_check.model_numbers(ref, s, ids, m["image_hw"])
        fh, fw = s["featmap_a"].shape[1:3]
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        for _ in range(s["draw"]):
            ref_pose.draw_noise(gen, wl["batch"], fh * fw, pipe["src_capacity"], dev)
        noise = ref_pose.draw_noise(gen, wl["batch"], fh * fw, pipe["src_capacity"], dev)

        def depth(side):
            d = np.stack([np.clip(r[side]["depth"], 0, 65535).astype(np.uint16) for r in reqs])
            return torch.as_tensor(d.astype(np.float32), device=dev)

        def cam(side):
            return torch.as_tensor(np.stack([r[side]["camera"] for r in reqs]), device=dev)

        s["depth"] = (depth("anchor"), depth("query"), cam("anchor"), cam("query"))
        numbers.update(serve_check.pose_numbers(ref_pose, pdsc, s, noise, pipe))
        readings.append(numbers)
    return serve_check.worst(readings)
