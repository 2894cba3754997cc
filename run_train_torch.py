#!/usr/bin/env python
"""Training CLI of the PyTorch port: counterpart of ``run_train.py``, with
its arguments and its output lines.

    python run_train_torch.py exp_name=myrun dataset.root=data \
        training.n_epochs=20 dataset.batch_size=32 [--device cpu]

An epoch loop over the train step of ``oryon_tpu_torch.train``: AdamW on
the fusion and decoder (and with ``model.train_towers=true`` the vision and
Swin towers), the LR on a cosine over the run, colour and flip augmentation
on the device (``augs.rgb.device``), the prompt embeddings from a cache,
a NaN guard every 10 steps, checkpoints every ``training.freq_save`` epochs
and on the last, a pose validation every ``training.freq_valid`` epochs when
``dataset.root/dataset.test.name`` exists, and the JSONL metric log.
``resume_ckpt`` (``last`` or an epoch) continues model, optimizer, step and
LR; ``init_params_from`` takes the weights only.  ``--config FILE`` reads a
YAML config first; ``key=value`` overrides use the config tree's grammar.
``--device`` (default ``cuda``) chooses where the model and the kernels run;
``--device cpu`` runs the kernels' plain versions; there is no fallback
from one to the other.

Several GPUs: launched by ``torchrun --nproc-per-node N``, each rank uses
``cuda:LOCAL_RANK`` and trains on its rows of every global batch of
``dataset.batch_size`` (``mesh.data`` ranks, -1: all of them // ``mesh.model``),
with the towers tensor-parallel over ``mesh.model``; the gradients are summed
over the data ranks, so the run is that of one device on the same batches.
Rank 0 alone prints, logs and writes checkpoints.  ``training.rss_restart_gib``
is read and ignored: it restarts the JAX trainer against a host-memory leak
of its TPU runtime, which this runtime does not have.
"""
from __future__ import annotations

import os
import sys
import types


def _flag(argv, name, default=None):
    for i, a in enumerate(argv):
        if a == name:
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def _datasets(cfg, model, device, on_device: bool):
    """(training dataset, validation dataset or None) of the config tree."""
    from oryon_tpu_torch.data.augment import AugmentConfig
    from oryon_tpu_torch.data.datasets import PairDataset, pick_reader
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer

    tok = ClipTokenizer(cfg.pretrained.vocabulary)
    ctx = model.text_cfg.context_length

    def tokenizer(prompts):
        return tok(prompts, context_length=ctx)

    def wrap_cache(reader, rgb_u8: bool = False):
        if cfg.dataset.cache_gib <= 0:
            return reader
        from oryon_tpu_torch.data.cache import CachedReader
        return CachedReader(reader, max_bytes=int(cfg.dataset.cache_gib * 2**30),
                            rgb_u8=rgb_u8)

    # with device augmentation the host keeps the synset prompts and the
    # correspondence sampling, and its colour and flip stack is off
    rgb = cfg.augs.rgb
    host_aug = AugmentConfig(jitter=rgb.jitter and not on_device,
                             bright=rgb.bright and not on_device,
                             hflip=rgb.hflip and not on_device,
                             vflip=rgb.vflip and not on_device,
                             out_size=tuple(cfg.dataset.img_size))
    # the model's prompt count (80 at full size, as in JAX)
    common = dict(max_corrs=cfg.dataset.max_corrs, img_size=cfg.dataset.img_size,
                  mask_type="oracle", device=device,
                  n_prompts=model.fusion_cfg.num_prompts + 1)
    root = os.path.join(cfg.dataset.root, cfg.dataset.train.name)
    train_ds = PairDataset(
        wrap_cache(pick_reader(cfg.dataset.train.name)(root), rgb_u8=on_device),
        cfg.dataset.train.split, tokenizer, augment=True, aug_cfg=host_aug,
        synset_aug=cfg.augs.text.synset, seed=cfg.seed if cfg.use_seed else 0,
        obj_split=str(cfg.dataset.train.obj), **common)
    valid_ds = None
    valid_root = os.path.join(cfg.dataset.root, cfg.dataset.test.name)
    if os.path.isdir(valid_root):
        try:
            reader = pick_reader(cfg.dataset.test.name)
        except KeyError:
            reader = None
        if reader is not None:
            valid_ds = PairDataset(wrap_cache(reader(valid_root)), cfg.dataset.test.split,
                                   tokenizer, augment=False, **common)
    return train_ds, valid_ds


def prepare(cfg, device: str = "cuda") -> types.SimpleNamespace:
    """Everything the epoch loop needs, built from the config tree: the
    datasets, the model (weights random from ``cfg.seed``, then the
    pretrained assets at size full, then ``init_params_from``), the train
    state (resumed by ``resume_ckpt``), the step, the prompt cache, the
    loader, the generator and the logger.  Prints the JAX CLI's lines."""
    import torch

    from oryon_tpu_torch.checkpoint import (init_experiment, logs_dir,
                                            restore_params_only, restore_train_state)
    from oryon_tpu_torch.data.device_augment import DeviceAugConfig
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.infer import full_precision_matmuls
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import build_model, resolve_attn_impl, resolve_quant
    from oryon_tpu_torch.parallel.mesh import (init_distributed, is_distributed, is_rank0,
                                               launched, make_mesh, place_params)
    from oryon_tpu_torch.parallel.tp import shard_params_tp
    from oryon_tpu_torch.pipeline import make_train_text_cache
    from oryon_tpu_torch.train import create_train_state, make_train_step
    from oryon_tpu_torch.utils.logging import MetricLogger

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to "
                           "train on the CPU")
    device = init_distributed(device) if launched() else torch.device(device)
    mesh = None
    if is_distributed():
        mesh = make_mesh(cfg.mesh.data, cfg.mesh.model, device=device)
    elif cfg.mesh.data not in (-1, 1) or cfg.mesh.model != 1:
        raise ValueError(f"mesh.data={cfg.mesh.data}, mesh.model={cfg.mesh.model} "
                         "needs several ranks: launch with torchrun --nproc-per-node N")
    full_precision_matmuls()   # f32 layers and the validation's pose math in full f32
    init_experiment(cfg, snapshot=True)
    logger = MetricLogger(logs_dir(cfg), cfg.exp_name) if is_rank0() else None

    size = cfg.model.size
    # training stays bf16 by default (model.train_quant): the int8 serving
    # default does not apply to the train step
    model = build_model(size, quant=resolve_quant(size, cfg.model.train_quant),
                        attn_impl=resolve_attn_impl(size, cfg.model.attn_impl),
                        train_towers=cfg.model.train_towers,
                        vlm=cfg.model.image_encoder.vlm)
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    on_device = bool(cfg.augs.rgb.device)
    train_ds, valid_ds = _datasets(cfg, model, device, on_device)
    print(f"TRAINING on {cfg.dataset.train.name}, split "
          f"{cfg.dataset.train.split}. Samples: {len(train_ds)}")
    if cfg.model.train_towers:
        print("train_towers=TRUE: CLIP-vision + Swin receive gradients "
              "(oryon_tpu control extension; reference freezes them)")
    steps_per_epoch = max(len(train_ds) // cfg.dataset.batch_size, 1)
    total_steps = steps_per_epoch * cfg.training.n_epochs
    loss_cfg = FeatureLossConfig(
        pos_margin=cfg.loss.pos_margin, neg_margin=cfg.loss.neg_margin,
        neg_kernel=cfg.loss.neg_kernel_size, neg_pool=cfg.loss.neg_pool,
        hard_negatives=cfg.loss.hard_negatives, mask_type=cfg.loss.mask_type,
        mask_threshold=cfg.test.mask_threshold,
        w_mask=cfg.loss.w.mask, w_pos=cfg.loss.w.pos, w_neg=cfg.loss.w.neg)

    if size == "full":
        from oryon_tpu_torch.models.pretrained import load_pretrained_params
        for line in load_pretrained_params(cfg, model):
            print(line)
    if cfg.init_params_from != "none":
        src_path = restore_params_only(cfg, model, cfg.init_params_from)
        print(f"warm-started params from {src_path} "
              "(fresh optimizer state / schedule)")
    model = model.to(device)
    if mesh is not None:
        # the unsharded weights as loaded, then each rank keeps its shards
        shard_params_tp(model, mesh)
        place_params(model, mesh)
    state = create_train_state(model, lr=cfg.optimization.lr,
                               weight_decay=cfg.optimization.w_decay,
                               total_steps=total_steps, gamma=cfg.optimization.gamma,
                               loss_cfg=loss_cfg, optim_type=cfg.optimization.optim_type,
                               scheduler_type=cfg.optimization.scheduler_type,
                               momentum=cfg.optimization.momentum)
    start_epoch = 0
    if cfg.resume_ckpt != "none":
        epoch = restore_train_state(cfg, state, cfg.resume_ckpt)
        start_epoch = epoch + 1
        print(f"Resumed from epoch {epoch}")
    if cfg.mesh.model > 1:
        print(f"tensor-parallel params over model axis = {cfg.mesh.model}")

    aug_cfg = None
    if on_device:
        rgb = cfg.augs.rgb
        aug_cfg = DeviceAugConfig(jitter=rgb.jitter, bright=rgb.bright,
                                  hflip=rgb.hflip, vflip=rgb.vflip)
    step_fn = make_train_step(aug_cfg, cfg.training.accum_steps, mesh)
    if cfg.training.accum_steps > 1:
        print(f"gradient accumulation: {cfg.training.accum_steps} micro-batches "
              f"of {cfg.dataset.batch_size // cfg.training.accum_steps}")
    if aug_cfg is not None:
        print("augmentations: on-device (color jitter + flips fused into "
              "the train step)")
    # each data rank collates its rows of the single-device batches
    rows = None if mesh is None else mesh.batch_rows(cfg.dataset.batch_size,
                                                     cfg.training.accum_steps)
    loader = PrefetchLoader(train_ds, cfg.dataset.batch_size, shuffle=True,
                            drop_last=True, train=True, rows=rows)
    return types.SimpleNamespace(
        cfg=cfg, device=device, mesh=mesh, model=model, state=state, step_fn=step_fn,
        train_ds=train_ds, valid_ds=valid_ds, loader=loader, logger=logger,
        text_cache=make_train_text_cache(model), start_epoch=start_epoch,
        generator=torch.Generator(device=device).manual_seed(cfg.seed))


def train_epoch(tr, profiler=None) -> int:
    """One pass of the loader through the train step; logs and checks the
    loss every 10 steps.  Returns the number of steps."""
    from oryon_tpu_torch.data.pair_batch import train_fields

    bi = -1
    for bi, batch in enumerate(tr.loader):
        batch = train_fields(batch._replace(text_emb=tr.text_cache(batch.prompt_ids)))
        state, metrics = tr.step_fn(tr.state, batch, tr.generator)
        if profiler is not None:
            profiler.step()
        if bi % 10 == 0:
            if tr.logger is not None:
                tr.logger.log_step(state.step, metrics, prefix="train")
            # a hard stop, so that a poisoned run fails fast (the metrics
            # are the global batch's, so every rank stops)
            total = float(metrics["loss/total"])
            if total != total:
                raise FloatingPointError(f"non-finite loss at step {state.step}")
    return bi + 1


def main(argv):
    """Returns the prepared run (``prepare``) after its last epoch."""
    from oryon_tpu_torch.parallel.mesh import rank0_output

    with rank0_output():
        return _main(argv)


def _main(argv):
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    from oryon_tpu_torch.checkpoint import logs_dir, save_train_state
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.utils.profiling import StepProfiler

    cfg = load_config(_flag(argv, "--config"), overrides)
    tr = prepare(cfg, _flag(argv, "--device", "cuda"))
    # cfg.profiler: one trace window over train steps 10-14
    profiler = StepProfiler(cfg.profiler, os.path.join(logs_dir(cfg), "profile"))
    try:
        for epoch in range(tr.start_epoch, cfg.training.n_epochs):
            train_epoch(tr, profiler)
            if tr.logger is not None:
                means = tr.logger.epoch_summary(epoch)
                print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
            if (epoch + 1) % cfg.training.freq_save == 0 or epoch == cfg.training.n_epochs - 1:
                print(f"saved {save_train_state(cfg, epoch, tr.state)}")
            if tr.valid_ds is not None and (epoch + 1) % cfg.training.freq_valid == 0:
                run_validation(cfg, tr.model, tr.state, tr.valid_ds, tr.generator, epoch,
                               logger=tr.logger, mesh=tr.mesh)
    finally:
        profiler.close()
        if tr.logger is not None:
            tr.logger.close()
    return tr


def run_validation(cfg, model, state, valid_ds, generator, epoch, logger=None, mesh=None):
    """Pose validation (no VSD) through the batched eval program, with the
    configured solver, or RANSAC when the PointDSC snapshot is absent (a
    random PointDSC would make the pose curves noise).  Returns the means
    (None on the ranks other than 0: over a ``mesh`` each batch is split
    over the data ranks and rank 0 scores)."""
    from oryon_tpu_torch.data.loader import PrefetchLoader
    from oryon_tpu_torch.eval.evaluator import BatchedEvaluator
    from oryon_tpu_torch.parallel.mesh import is_rank0
    from oryon_tpu_torch.pipeline import (build_pipeline, build_pointdsc_solver,
                                          make_pipeline_config, pointdsc_weights_available,
                                          run_test_epoch)

    device = next(model.parameters()).device
    solver, pointdsc = cfg.test.solver, None
    if solver == "pointdsc":
        if pointdsc_weights_available(cfg.pretrained.pointdsc):
            pointdsc = build_pointdsc_solver(cfg.pretrained.pointdsc).to(device)
        else:
            print("WARNING: PointDSC snapshot absent; validating with RANSAC "
                  "so pose metrics stay meaningful")
            solver = "ransac"
    model.eval()
    run = build_pipeline(model, make_pipeline_config(cfg, solver, mask_source="predicted"),
                         pointdsc, mesh)

    def pipe(batch, text_emb=None):
        return run(batch, text_emb, generator=generator)

    loader = PrefetchLoader(valid_ds, cfg.dataset.batch_size, sort_by_class=True)
    if not is_rank0():
        run_test_epoch(pipe, valid_ds, None, cfg.dataset.batch_size, loader=loader, score=False)
        return None
    ev = BatchedEvaluator(cfg.exp_tag, compute_vsd=False, device=device)
    ev.add_object_info(valid_ds.reader.object_info())
    ev.init_test()
    run_test_epoch(pipe, valid_ds, ev, cfg.dataset.batch_size, compute_vsd=False,
                   loader=loader)
    means = ev.get_means()
    print(f"valid epoch {epoch}: " +
          " ".join(f"{k}={v:.3f}" for k, v in sorted(means.items())
                   if isinstance(v, float)))
    if logger is not None:
        logger.log_step(state.step, {k.replace(" ", "_"): v for k, v in means.items()
                                     if isinstance(v, float)}, prefix="valid_metric")
    return means


if __name__ == "__main__":
    from oryon_tpu_torch.parallel.mesh import shutdown

    main(sys.argv[1:])
    shutdown()
