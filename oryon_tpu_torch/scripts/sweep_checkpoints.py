"""Per-checkpoint evaluation sweep: score every saved epoch of an
experiment on the fixed split and tabulate the pose metrics side by side.

Counterpart of ``scripts/sweep_checkpoints.py``.  The dataset, the model
and the solver are built once (``run_test_torch.prepare``); each epoch
restores its weights into the model, rebuilds the pipeline and the prompt
cache, and runs a fresh ``BatchedEvaluator`` on the device.  Without
PointDSC weights the sweep runs RANSAC and says so.

    python -m oryon_tpu_torch.scripts.sweep_checkpoints exp_name=prod40 \
        dataset.root=data_synth dataset.test.name=shapenet6d \
        dataset.test.split=val [--epochs=4,9,last] [--device cpu]

``--epochs`` defaults to every checkpoint on disk, ascending.  Prints one
JSON line per epoch and the best epoch by AR (ADD(S)-0.1d without VSD), and
writes the table to ``<exp>/results/ckpt_sweep_<stamp>.json``.  One process.
"""
from __future__ import annotations

import sys
import types


def main(argv) -> types.SimpleNamespace:
    """Returns the rows, the best row, the table's path, and each epoch's
    seconds and kernel launches."""
    from oryon_tpu_torch.checkpoint import list_checkpoints, restore_checkpoint
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.pipeline import make_pipeline_config
    from oryon_tpu_torch.scripts import _sweep
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import flag, overrides

    epochs_arg = flag(argv, "--epochs", "all")
    device = _device(argv)
    cfg = load_config(None, overrides(argv))
    ckpts = list_checkpoints(cfg)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under the {cfg.exp_name!r} experiment")
    if epochs_arg == "all":
        wanted = [e for e, _ in ckpts]
    else:
        by_epoch = dict(ckpts)
        wanted = []
        for tok in epochs_arg.split(","):
            e = ckpts[-1][0] if tok == "last" else int(tok)
            if e not in by_epoch:
                raise FileNotFoundError(f"no checkpoint for epoch {e}")
            wanted.append(e)

    sw = _sweep.prepare(cfg, device)
    print(f"SWEEP on {cfg.dataset.test.name}/{cfg.dataset.test.split}: "
          f"{len(sw.ds)} pairs, quant={cfg.model.quant}, epochs={wanted}", flush=True)
    solver, pointdsc = cfg.test.solver, None
    if solver == "pointdsc":
        pointdsc = _sweep.load_pointdsc(cfg, sw.device)
        if pointdsc is None:
            print("WARNING: PointDSC snapshot absent; sweeping with RANSAC")
            solver = "ransac"
    pcfg = make_pipeline_config(cfg, solver)

    obj_info = sw.ds.reader.object_info()
    rows, seconds, launches = [], [], []
    for want in wanted:
        epoch, _ = restore_checkpoint(cfg, sw.model, str(want))
        res = _sweep.score(sw, cfg, pcfg, pointdsc, f"{cfg.exp_tag}-e{epoch}", obj_info)
        row = {"epoch": epoch, "n_pairs": res.n, **res.means}
        rows.append(row)
        seconds.append(res.seconds)
        launches.append(res.launches)
        _sweep.print_row(row)

    rank_key, best = _sweep.best_row(rows, "epoch")
    path = _sweep.write_table(cfg, "ckpt_sweep", {
        "config": {"dataset": cfg.dataset.test.name, "split": cfg.dataset.test.split,
                   "mask": cfg.test.mask, "solver": solver, "quant": cfg.model.quant},
        "rows": rows, "rank_key": rank_key, "best_epoch": best["epoch"]})
    return types.SimpleNamespace(rows=rows, best=best, path=path, seconds=seconds,
                                 launches=launches)


if __name__ == "__main__":
    main(sys.argv[1:])
