"""Evaluation-time hyper-parameter sweep on one checkpoint: score a grid of
matching / solver / mask settings side by side without retraining.

Counterpart of ``scripts/sweep_eval_hparams.py``.  The dataset, the model
with its restored weights and the PointDSC weights are built once; each
variant re-derives the config and rebuilds only the pipeline, scoring on the
device with a fresh ``BatchedEvaluator``.

    python -m oryon_tpu_torch.scripts.sweep_eval_hparams exp_name=prod40 \
        eval.ckpt=<best> dataset.root=data_synth dataset.test.name=shapenet6d \
        dataset.test.split=val [--variants="test.dist_th=0.15;test.solver=ransac"] \
        [--device cpu]

``--variants`` is a ';'-separated list of override groups (whitespace-
separated overrides in a group; an empty group is the shipped defaults),
``DEFAULT_GRID`` otherwise.  Prints one JSON line per variant and writes the
table to ``<exp>/results/eval_hparams_<stamp>.json``.  One process.
"""
from __future__ import annotations

import sys
import types

# the shipped defaults' neighbourhood: match acceptance threshold, solver
# correspondence budget, mask binarisation, and RANSAC for comparison
DEFAULT_GRID = [
    [],
    ["test.dist_th=0.15"],
    ["test.dist_th=0.2"],
    ["test.dist_th=0.3"],
    ["test.n_corrs=1000"],
    ["test.mask_threshold=0.4"],
    ["test.mask_threshold=0.6"],
    ["test.solver=ransac"],
]


def main(argv) -> types.SimpleNamespace:
    """Returns the rows, the best row, the table's path, the epoch, and each
    variant's seconds and kernel launches."""
    from oryon_tpu_torch.checkpoint import restore_checkpoint
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.pipeline import make_pipeline_config
    from oryon_tpu_torch.scripts import _sweep
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import flag, overrides

    variants_arg = flag(argv, "--variants")
    grid = (DEFAULT_GRID if variants_arg is None
            else [g.split() for g in variants_arg.split(";")])
    device = _device(argv)
    base = overrides(argv)
    cfg = load_config(None, base)

    sw = _sweep.prepare(cfg, device)
    ckpt = cfg.eval.ckpt if cfg.eval.ckpt not in (None, "") else "last"
    epoch, _ = restore_checkpoint(cfg, sw.model, str(ckpt))
    print(f"HPARAM SWEEP on {cfg.dataset.test.name}/{cfg.dataset.test.split}: "
          f"{len(sw.ds)} pairs, epoch {epoch}, {len(grid)} variants", flush=True)
    # PointDSC loads once; the variants that switch solver reuse it
    pointdsc = _sweep.load_pointdsc(cfg, sw.device)
    obj_info = sw.ds.reader.object_info()

    rows, seconds, launches = [], [], []
    for group in grid:
        label = " ".join(group) if group else "default"
        print(f"variant {label!r} ...", flush=True)
        cfg_v = load_config(None, base + group)
        solver = cfg_v.test.solver
        if solver == "pointdsc" and pointdsc is None:
            print(f"WARNING: PointDSC weights absent; {label!r} falls back to RANSAC")
            solver = "ransac"
        res = _sweep.score(sw, cfg, make_pipeline_config(cfg_v, solver), pointdsc,
                           f"{cfg.exp_tag}-hp", obj_info)
        row = {"variant": label, "n_pairs": res.n, **res.means}
        rows.append(row)
        seconds.append(res.seconds)
        launches.append(res.launches)
        _sweep.print_row(row)

    rank_key, best = _sweep.best_row(rows, "variant")
    path = _sweep.write_table(cfg, "eval_hparams", {
        "config": {"dataset": cfg.dataset.test.name, "split": cfg.dataset.test.split,
                   "epoch": epoch, "quant": cfg.model.quant},
        "rows": rows, "rank_key": rank_key, "best_variant": best["variant"]})
    return types.SimpleNamespace(rows=rows, best=best, path=path, epoch=epoch,
                                 seconds=seconds, launches=launches)


if __name__ == "__main__":
    main(sys.argv[1:])
