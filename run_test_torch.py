#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port: counterpart of ``run_test.py``, with
its arguments and its output lines.

    python run_test_torch.py dataset.root=data dataset.test.name=nocs \
        test.mask=oracle eval.ckpt=last [--device cpu]

Runs the batched pipeline over the fixed test split (REAL275 ``nocs`` or
Toyota-Light ``toyl`` trees), scores every pair (R/t errors, ADD(S)-0.1d,
MSSD, MSPD, VSD and their mean AR) and writes the prediction CSV, the
metrics JSON and ``config_<stamp>.yaml`` under the experiment's results
directory; prints "TESTING on ...", one LaTeX row per class, the "Ours &"
row and "registered N pairs -> <csv>".  ``--config FILE`` reads a YAML
config first; ``key=value`` overrides use the config tree's grammar.
``--device`` (default ``cuda``) chooses where the model, the kernels and the
scoring run; ``--device cpu`` runs the kernels' plain PyTorch versions.

One card: a device mesh (``mesh.data`` above 1, ``mesh.model`` above 1) is
refused; ``mesh.data=-1`` means the one device.  A missing PointDSC
snapshot falls back to RANSAC with a WARNING, as ``run_test.py`` does.
"""
from __future__ import annotations

import os
import sys
import types
from datetime import datetime


def _flag(argv, name, default=None):
    for i, a in enumerate(argv):
        if a == name:
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def prepare(cfg, device: str = "cuda") -> types.SimpleNamespace:
    """Everything one sweep needs, built from the config tree: dataset,
    model (weights: seed, pretrained at size full, ``eval.ckpt``), PointDSC
    or RANSAC, the batch program, the evaluator with the split's objects,
    the per-class text cache and the prefetching loader."""
    import torch

    from oryon_tpu_torch.checkpoint import init_experiment
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.infer import full_precision_matmuls, model_from_config
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer
    from oryon_tpu_torch.pipeline import (build_pointdsc_solver, make_pipeline_config,
                                          make_run_fn, make_text_cache,
                                          pointdsc_weights_available)

    if cfg.mesh.data not in (-1, 1) or cfg.mesh.model != 1:
        raise NotImplementedError(
            f"mesh.data={cfg.mesh.data}, mesh.model={cfg.mesh.model}: the port "
            "evaluates on one device; serving over several is ROADMAP.md queue 1 "
            "item 6")
    device = torch.device(device)
    full_precision_matmuls()   # pose math and scoring in full f32
    init_experiment(cfg)
    model, epoch = model_from_config(cfg)
    if epoch is not None:
        # is not None: eval.ckpt=0 (epoch zero) is valid
        if epoch < 0:
            raise FileNotFoundError(
                f"eval.ckpt={cfg.eval.ckpt!r} requested but no checkpoint "
                f"found under the experiment's models dir")
        print(f"loaded checkpoint epoch {epoch}")
    model = model.to(device).eval()

    tok = ClipTokenizer(cfg.pretrained.vocabulary)
    ctx = model.text_cfg.context_length

    def tokenizer(prompts):
        return tok(prompts, context_length=ctx)

    root = os.path.join(cfg.dataset.root, cfg.dataset.test.name)
    reader = pick_reader(cfg.dataset.test.name)(root)
    if cfg.dataset.cache_gib > 0:
        from oryon_tpu_torch.data.cache import CachedReader
        reader = CachedReader(reader, max_bytes=int(cfg.dataset.cache_gib * 2**30))
    ds = PairDataset(reader, cfg.dataset.test.split, tokenizer,
                     max_corrs=cfg.dataset.max_corrs, img_size=cfg.dataset.img_size,
                     augment=False, debug_valid=cfg.debug_valid,
                     mask_type="oracle" if cfg.test.mask == "predicted" else cfg.test.mask,
                     add_description=str(cfg.test.add_description),
                     obj_split=str(cfg.dataset.test.obj), device=device,
                     # the model's prompt count (80 at full size, as in JAX)
                     n_prompts=model.fusion_cfg.num_prompts + 1)

    # the configured solver; a missing PointDSC snapshot would solve poses
    # with a random network, so RANSAC stands in, loudly
    solver, pointdsc = cfg.test.solver, None
    if solver == "pointdsc":
        if pointdsc_weights_available(cfg.pretrained.pointdsc):
            pointdsc = build_pointdsc_solver(cfg.pretrained.pointdsc).to(device)
        else:
            print("WARNING: PointDSC snapshot absent; evaluating with RANSAC "
                  "so pose metrics stay meaningful")
            solver = "ransac"
    pcfg = make_pipeline_config(cfg, solver)
    run = make_run_fn(model, pcfg, pointdsc)
    generator = torch.Generator(device=device).manual_seed(cfg.seed if cfg.use_seed else 1)

    def pipe(batch, text_emb=None):
        return run(batch, text_emb, generator=generator)

    ev = BatchedEvaluator(cfg.exp_tag, compute_vsd=cfg.compute_vsd,
                          vsd_window=cfg.eval.vsd_window, device=device)
    ev.add_object_info(ds.reader.object_info())
    ev.init_test()
    loader = PrefetchLoader(ds, cfg.dataset.batch_size, sort_by_class=True)
    return types.SimpleNamespace(cfg=cfg, device=device, model=model, pointdsc=pointdsc,
                                 pcfg=pcfg, run=run, pipe=pipe, ds=ds, evaluator=ev,
                                 text_cache=make_text_cache(model), loader=loader)


def main(argv):
    """Returns the prepared sweep (``prepare``) with the written paths and
    the number of pairs registered."""
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    from oryon_tpu_torch.checkpoint import results_dir
    from oryon_tpu_torch.config import load_config, save_config
    from oryon_tpu_torch.pipeline import run_test_epoch
    from oryon_tpu_torch.utils.profiling import StepProfiler

    cfg = load_config(_flag(argv, "--config"), overrides)
    sw = prepare(cfg, _flag(argv, "--device", "cuda"))
    print(f"TESTING on {cfg.dataset.test.name}, split {cfg.dataset.test.split}."
          f" Samples: {len(sw.ds)}")

    stamp = datetime.now().strftime("%d%m%Y_%H%M")
    tag = f"{cfg.dataset.test.name}_{cfg.dataset.test.split}_{cfg.dataset.test.obj}_{stamp}"
    rdir = results_dir(cfg)
    save_config(cfg, os.path.join(rdir, f"config_{stamp}.yaml"))
    save_hook = None
    if cfg.test.only_save_masks:
        from oryon_tpu_torch.utils.savers import make_mask_saver
        save_hook = make_mask_saver(os.path.join(rdir, "pred_masks"))
    elif cfg.test.only_save_featmaps:
        from oryon_tpu_torch.utils.savers import make_featmap_saver
        save_hook = make_featmap_saver(os.path.join(rdir, "featmaps"))
    viz_dir = None
    if cfg.viz_valid:
        viz_dir = os.path.join(rdir, "viz")
        os.makedirs(viz_dir, exist_ok=True)
    # cfg.profiler: one trace window over sweep batches 10-14
    profiler = StepProfiler(cfg.profiler, os.path.join(rdir, "profile"))
    sw.csv = os.path.join(rdir, tag + ".csv")
    sw.json = os.path.join(rdir, tag + ".json")
    with open(sw.csv, "w") as csv_fp:
        sw.n = run_test_epoch(sw.pipe, sw.ds, sw.evaluator, cfg.dataset.batch_size,
                              csv_fp=csv_fp, compute_vsd=cfg.compute_vsd,
                              text_cache=sw.text_cache, save_hook=save_hook,
                              viz_dir=viz_dir, loader=sw.loader, step_profiler=profiler)
    with open(sw.json, "w") as f:
        sw.evaluator.save(f)
    for row in sw.evaluator.test_summary():
        print(row)
    print(sw.evaluator.get_latex_str())
    print(f"registered {sw.n} pairs -> {rdir}/{tag}.csv")
    return sw


if __name__ == "__main__":
    main(sys.argv[1:])
