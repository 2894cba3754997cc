"""What the two sweeps share: the evaluation of ``run_test_torch.prepare``
built once without a checkpoint, and one scored pass over the split per
checkpoint or variant, each with a fresh pipeline, prompt cache, evaluator,
loader and noise generator (seeded as ``run_test_torch``'s)."""
from __future__ import annotations

import copy
import json
import os
import sys
import time
import types
from datetime import datetime

# run_test_torch.py lies at the root of the checkout, beside the package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def prepare(cfg, device: str):
    """``run_test_torch.prepare`` of ``cfg`` with no checkpoint restored and
    no solver built (each pass chooses its own)."""
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import run_test_torch

    bare = copy.deepcopy(cfg)
    bare.eval.ckpt = ""
    bare.test.solver = "ransac"
    return run_test_torch.prepare(bare, device)


def load_pointdsc(cfg, device):
    """The trained PointDSC module on ``device``, or None without weights."""
    from oryon_tpu_torch.pipeline import build_pointdsc_solver, pointdsc_weights_available
    if not pointdsc_weights_available(cfg.pretrained.pointdsc):
        return None
    return build_pointdsc_solver(cfg.pretrained.pointdsc).to(device)


def score(sw, cfg, pcfg, pointdsc, tag: str, obj_info) -> types.SimpleNamespace:
    """One pass over the split: (pairs, metric means, seconds, kernel
    launches of the pass)."""
    import torch

    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.ops.cuda import launch_counts
    from oryon_tpu_torch.pipeline import build_pipeline, make_text_cache, run_test_epoch

    run = build_pipeline(sw.model, pcfg, pointdsc, sw.mesh)
    generator = torch.Generator(device=sw.device).manual_seed(cfg.seed if cfg.use_seed else 1)
    ev = BatchedEvaluator(tag, compute_vsd=cfg.compute_vsd, vsd_window=cfg.eval.vsd_window,
                          device=sw.device)
    ev.add_object_info(obj_info)
    ev.init_test()
    B = cfg.dataset.batch_size
    before, t0 = launch_counts(), time.perf_counter()
    n = run_test_epoch(lambda batch, text: run(batch, text, generator=generator), sw.ds, ev,
                       B, compute_vsd=cfg.compute_vsd, text_cache=make_text_cache(sw.model),
                       loader=PrefetchLoader(sw.ds, B, sort_by_class=True))
    seconds = time.perf_counter() - t0
    after = launch_counts()
    return types.SimpleNamespace(
        n=n, means={k: float(v) for k, v in ev.get_means().items()}, seconds=seconds,
        launches={k: after[k] - before[k] for k in after})


def print_row(row: dict) -> None:
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in row.items()}), flush=True)


def best_row(rows, what: str):
    """The best row by AR (when VSD ran) or ADD(S)-0.1d; prints the line
    (a variant's label quoted)."""
    rank_key = "AR" if all("AR" in r for r in rows) else "ADD(S)-0.1d"
    best = max(rows, key=lambda r: r.get(rank_key, float("-inf")))
    shown = repr(best[what]) if what == "variant" else best[what]
    print(f"best {what} by {rank_key}: {shown} "
          f"({rank_key}={best.get(rank_key, float('nan')):.4f})")
    return rank_key, best


def write_table(cfg, prefix: str, table: dict) -> str:
    from oryon_tpu_torch.checkpoint import results_dir
    stamp = datetime.now().strftime("%d%m%Y_%H%M")
    os.makedirs(results_dir(cfg), exist_ok=True)
    out = os.path.join(results_dir(cfg), f"{prefix}_{stamp}.json")
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {out}")
    return out
