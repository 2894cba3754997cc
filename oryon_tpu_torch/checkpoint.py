"""Checkpoints and the experiment folder.

Counterpart of ``oryon_tpu/checkpoint.py`` with its layout and semantics:
``<exp_root>/<exp_name>/{models,results,logs}`` and a ``config.yaml``
beside them; one entry ``models/epoch=NNNN`` per saved epoch, all kept;
restore by epoch number or "last".

An entry is a directory that holds one of two files:

  * ``state.pt``, the port's own: ``{"model": state_dict, "optimizer":
    state_dict or None, "step": int}`` written by ``torch.save``.  The
    directory is written under a temporary name and renamed, so a crash
    leaves no ``epoch=NNNN``.
  * ``params.npz``, weights trained by the JAX package: a flat npz of
    '/'-joined flax variable paths (``params/vlm_visual/...``), read through
    ``models.convert.from_jax_params``.  It carries no optimizer state.

The JAX package writes its entries with orbax, which the port does not
read: such a directory holds neither file and raises, naming the export.

Several GPUs (``parallel/``): every rank calls save and restore.  A save
gathers the tensor-parallel shards of the parameters and of the optimizer's
moments (``parallel.tp.full_state_dict``), so the entry holds the unsharded
state in the same format; rank 0 writes it and the other ranks wait at a
barrier.  A restore reads the entry on every rank and cuts it to the rank's
shards.  ``init_experiment`` writes on rank 0 only.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import List, Optional, Tuple

import torch

from oryon_tpu_torch.config import Config, save_config
from oryon_tpu_torch.models.convert import from_jax_params, load_flax_npz
from oryon_tpu_torch.parallel.mesh import barrier, is_rank0
from oryon_tpu_torch.parallel.tp import (full_optimizer_state, full_state_dict,
                                         local_optimizer_state, local_state_dict)

STATE_FILE = "state.pt"
PARAMS_FILE = "params.npz"


def ckpt_dir(cfg: Config) -> str:
    return os.path.join(cfg.exp_root, cfg.exp_name, "models")


def results_dir(cfg: Config) -> str:
    return os.path.join(cfg.exp_root, cfg.exp_name, "results")


def logs_dir(cfg: Config) -> str:
    return os.path.join(cfg.exp_root, cfg.exp_name, "logs")


def init_experiment(cfg: Config, snapshot: bool = False) -> None:
    """Create the experiment tree and its config record.

    ``snapshot=True`` (training) refreshes ``<exp>/config.yaml``.  Evaluation
    and serving leave an existing file alone, so their overrides never
    replace the record of how the experiment was trained; the file is still
    written when absent."""
    if is_rank0():
        for d in (ckpt_dir(cfg), results_dir(cfg), logs_dir(cfg)):
            os.makedirs(d, exist_ok=True)
        path = os.path.join(cfg.exp_root, cfg.exp_name, "config.yaml")
        if snapshot or not os.path.exists(path):
            save_config(cfg, path)
    barrier()


def save_checkpoint(cfg: Config, epoch: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> str:
    """Write ``models/epoch=NNNN/state.pt``; an entry of the same epoch is
    replaced.  Returns the entry's path.  Every rank of a job calls it (the
    shards are gathered); rank 0 writes."""
    path = os.path.abspath(os.path.join(ckpt_dir(cfg), f"epoch={epoch:04d}"))
    state = {"model": full_state_dict(model),
             "optimizer": None if optimizer is None else full_optimizer_state(optimizer, model),
             "step": int(step)}
    if is_rank0():
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
    barrier()
    return path


def list_checkpoints(cfg: Config) -> List[Tuple[int, str]]:
    d = ckpt_dir(cfg)
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        # fullmatch: a half-written entry ('epoch=NNNN.tmp-*', or the JAX
        # package's 'epoch=NNNN.orbax-checkpoint-tmp-*') is not a checkpoint
        m = re.fullmatch(r"epoch=(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(d, name)))
    return sorted(out)


def _read_entry(path: str) -> dict:
    """{"model": state_dict, "optimizer", "step"} of one ``epoch=NNNN``."""
    state = os.path.join(path, STATE_FILE)
    if os.path.exists(state):
        # memory-mapped: the tensors are read as the module copies them in,
        # so no second copy of the model is held
        return torch.load(state, map_location="cpu", weights_only=True, mmap=True)
    params = os.path.join(path, PARAMS_FILE)
    if os.path.exists(params):
        return {"model": from_jax_params(load_flax_npz(params)),
                "optimizer": None, "step": 0}
    raise ValueError(
        f"{path} holds neither {STATE_FILE} nor {PARAMS_FILE}. A checkpoint "
        "written by the JAX package (orbax) must first be exported to "
        f"{PARAMS_FILE}: a flat npz of its params tree with '/'-joined paths "
        "('params/vlm_visual/...').")


def _load_model(model: torch.nn.Module, state_dict: dict, what: str) -> None:
    try:
        model.load_state_dict(local_state_dict(model, state_dict), strict=True)
    except RuntimeError as e:
        raise ValueError(f"{what} (different model.size/topology?): {e}") from None


def _pick(ckpts: List[Tuple[int, str]], which: str) -> Optional[Tuple[int, str]]:
    if which == "last":
        return ckpts[-1]
    wanted = int(which)
    return next((c for c in ckpts if c[0] == wanted), None)


def restore_checkpoint(cfg: Config, model: torch.nn.Module, which: str = "last",
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> Tuple[int, int]:
    """Load a checkpoint of ``cfg``'s experiment into ``model`` (and into
    ``optimizer`` when given and saved), in place.  ``which`` is "last" or an
    epoch number.  Returns (epoch, step); (-1, 0) and nothing loaded when the
    experiment has no checkpoint."""
    ckpts = list_checkpoints(cfg)
    if not ckpts:
        return -1, 0
    found = _pick(ckpts, which)
    if found is None:
        raise FileNotFoundError(f"no checkpoint for epoch {int(which)}")
    epoch, path = found
    entry = _read_entry(path)
    _load_model(model, entry["model"], f"param tree mismatch vs {path}")
    if optimizer is not None and entry["optimizer"] is not None:
        optimizer.load_state_dict(local_optimizer_state(optimizer, model, entry["optimizer"]))
    return epoch, int(entry["step"])


def save_train_state(cfg: Config, epoch: int, state) -> str:
    """``save_checkpoint`` of a ``train.TrainState``: model, optimizer and
    the optimizer steps taken, which fix the LR schedule's position."""
    return save_checkpoint(cfg, epoch, state.model, state.optimizer, state.step)


def restore_train_state(cfg: Config, state, which: str = "last") -> int:
    """Resume a ``train.TrainState`` in place: model, optimizer state and
    step, and so the LR schedule where it stood.  Returns the epoch; -1 and
    nothing restored when the experiment has no checkpoint."""
    epoch, step = restore_checkpoint(cfg, state.model, which, state.optimizer)
    if epoch >= 0:
        state.step = step
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(step)
    return epoch


def restore_params_only(cfg: Config, model: torch.nn.Module, spec: str) -> str:
    """Warm-start ``model`` from another experiment's checkpoint; optimizer
    state and step stay fresh (``cfg.init_params_from``).

    ``spec``: '<exp_name>', '<exp_name>:<epoch|last>', or a path to an
    'epoch=NNNN' directory.  Returns the resolved path."""
    if os.path.isdir(spec):
        path = os.path.abspath(spec)
    else:
        exp, _, which = spec.partition(":")
        which = which or "last"
        src_cfg = dataclasses.replace(cfg, exp_name=exp)
        ckpts = list_checkpoints(src_cfg)
        if not ckpts:
            raise FileNotFoundError(
                f"init_params_from={spec}: no checkpoints in {ckpt_dir(src_cfg)}")
        found = _pick(ckpts, which)
        if found is None:
            raise FileNotFoundError(
                f"init_params_from={spec}: no checkpoint for epoch {which} in "
                f"{ckpt_dir(src_cfg)}")
        path = os.path.abspath(found[1])
    _load_model(model, _read_entry(path)["model"],
                f"init_params_from={spec}: param tree mismatch vs {path}")
    return path
