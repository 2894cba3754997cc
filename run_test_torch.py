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

Several GPUs: launched by ``torchrun --nproc-per-node N``, each rank uses
``cuda:LOCAL_RANK`` and the batches are split over ``mesh.data`` ranks, with
the towers tensor-parallel over ``mesh.model`` (``serving_mesh``'s policy:
one device, with a WARNING, when the mesh does not fit the job or the
batch).  Every rank loads each batch; rank 0 alone prints, scores and
writes.  A missing PointDSC snapshot falls back to RANSAC with a WARNING, as
``run_test.py`` does.
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
    or RANSAC, the batch program (over the mesh, when the job has several
    ranks), the evaluator with the split's objects (rank 0; None on the
    others), the per-class text cache and the prefetching loader."""
    import torch

    from oryon_tpu_torch.parallel.mesh import init_distributed, launched

    from oryon_tpu_torch.checkpoint import init_experiment
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.infer import full_precision_matmuls, model_from_config
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer
    from oryon_tpu_torch.parallel.mesh import is_rank0, place_params, serving_mesh
    from oryon_tpu_torch.parallel.tp import shard_params_tp
    from oryon_tpu_torch.pipeline import (build_pipeline, build_pointdsc_solver,
                                          make_pipeline_config, make_text_cache,
                                          pointdsc_weights_available)

    device = init_distributed(device) if launched() else torch.device(device)
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
    # several GPUs: the batch split over the data axis (replicated params;
    # an optional TP axis shards the towers)
    mesh = serving_mesh(cfg.mesh.data, cfg.mesh.model, cfg.dataset.batch_size, label="eval",
                        device=device)
    if mesh is not None:
        if cfg.mesh.model > 1:
            shard_params_tp(model, mesh)
        place_params(model, mesh)
    run = build_pipeline(model, pcfg, pointdsc, mesh)
    generator = torch.Generator(device=device).manual_seed(cfg.seed if cfg.use_seed else 1)

    def pipe(batch, text_emb=None):
        return run(batch, text_emb, generator=generator)

    ev = None
    if is_rank0():
        ev = BatchedEvaluator(cfg.exp_tag, compute_vsd=cfg.compute_vsd,
                              vsd_window=cfg.eval.vsd_window, device=device)
        ev.add_object_info(ds.reader.object_info())
        ev.init_test()
    loader = PrefetchLoader(ds, cfg.dataset.batch_size, sort_by_class=True)
    return types.SimpleNamespace(cfg=cfg, device=device, model=model, pointdsc=pointdsc,
                                 pcfg=pcfg, mesh=mesh, run=run, pipe=pipe, ds=ds, evaluator=ev,
                                 text_cache=make_text_cache(model), loader=loader)


def main(argv):
    """Returns the prepared sweep (``prepare``) with the written paths and
    the number of pairs registered (0 on the ranks other than 0)."""
    from oryon_tpu_torch.parallel.mesh import rank0_output

    with rank0_output():
        return _main(argv)


def _main(argv):
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    from oryon_tpu_torch.checkpoint import results_dir
    from oryon_tpu_torch.config import load_config, save_config
    from oryon_tpu_torch.parallel.mesh import is_rank0
    from oryon_tpu_torch.pipeline import run_test_epoch
    from oryon_tpu_torch.utils.profiling import StepProfiler

    cfg = load_config(_flag(argv, "--config"), overrides)
    sw = prepare(cfg, _flag(argv, "--device", "cuda"))
    if not is_rank0():
        # the other ranks take part in each batch's collectives only
        sw.n = run_test_epoch(sw.pipe, sw.ds, None, cfg.dataset.batch_size,
                              text_cache=sw.text_cache, loader=sw.loader, score=False)
        return sw
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
    from oryon_tpu_torch.parallel.mesh import shutdown

    main(sys.argv[1:])
    shutdown()
