"""Training machinery: optimizer partition, LR schedule, the train step.

Counterpart of ``oryon_tpu/train.py``:

* the optimizer holds the trainable parameters only (fusion and decoder;
  with ``train_towers`` also the vision and Swin towers, never the text
  tower), so frozen parameters get no state and no decay, as optax's
  ``set_to_zero`` partition gives;
* ``Adam`` and ``AdamW`` both mean decoupled AdamW with optax's arithmetic
  (``AdamW`` below), as ``optax.adamw`` serves both there
  (``torch.optim.Adam``'s L2 decay would be another result); ``SGD``
  adds the decayed weights to the gradient and then applies momentum, as
  ``optax.chain(add_decayed_weights, sgd)``;
* the LR follows a cosine from ``lr`` to ``gamma * lr`` over the run, stepped
  per optimizer step and read at the count before the step, as optax reads
  its schedule;
* ``train_step``: optional on-device augmentation, forward, the contrastive
  and mask loss, backward, one optimizer step.  ``accum_steps`` > 1 splits
  the batch into micro-batches and applies the mean of their gradients; the
  metrics are the mean of their metrics (the JAX package's weighting: the
  mean of micro-batch means).

Data-parallel (``mesh``, ``parallel/mesh.py``): each rank holds its rows of
the global batch (``parallel.mesh.batch_rows``: its 1/n of each global
micro-batch, as the JAX package's reshape of the global batch forms them),
draws every random input for the global batch from the shared-seed generator
and keeps its rows, computes its share of the global loss
(``feature_loss(group=...)``), and the gradients are summed over ``data``
before the same AdamW step on every rank: the step of one device on the
global batch.  DDP's mean of the ranks' mean losses would be another
function wherever the valid pairs are spread unevenly over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from oryon_tpu_torch.data.device_augment import (AugFactors, DeviceAugConfig, apply_factors,
                                                 device_augment, draw_factors)
from oryon_tpu_torch.data.pair_batch import PairBatch, device_fields
from oryon_tpu_torch.losses.feature_loss import (FeatureLossConfig, draw_indices,
                                                 feature_loss)
from oryon_tpu_torch.models.oryon import OryonModel
from oryon_tpu_torch.parallel.mesh import all_reduce_, all_reduce_coalesced_

TRAINABLE_PREFIXES = ("fusion", "decoder")
TOWERS = ("vlm_visual", "guidance")


def trainable_label(name: str, train_towers: bool = False) -> str:
    """'train' for a parameter of the fusion or decoder (and, with
    ``train_towers``, of the vision or Swin tower), 'frozen' otherwise;
    ``name`` as in ``named_parameters``."""
    top = name.split(".", 1)[0]
    if top in TRAINABLE_PREFIXES or (train_towers and top in TOWERS):
        return "train"
    return "frozen"


def cosine_lr(base_lr: float, total_steps: int, gamma: float) -> Callable[[int], float]:
    """Cosine from base_lr at step 0 to gamma * base_lr at total_steps - 1,
    flat after it; evaluated in float32, as the JAX schedule is."""
    f32 = np.float32
    floor = gamma * base_lr
    half_amp = f32(0.5 * (base_lr - floor))   # the constants fold in float64 there

    def sched(step: int) -> float:
        t = np.clip(f32(step) / f32(max(total_steps - 1, 1)), f32(0), f32(1))
        return float(f32(floor) + half_amp * (f32(1) + np.cos(f32(math.pi) * t)))

    return sched


class AdamW(torch.optim.Optimizer):
    """Decoupled AdamW with ``optax.adamw``'s arithmetic, all in float32:
    mu and nu are the moments, ``1 - b ** count`` is formed in float32 (as
    optax forms it; ``torch.optim.AdamW`` forms it in float64, which moves a
    first step by up to 6e-6 of its size), and the update is
    ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(count=0, mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p))
            states = [self.state[p] for p in ps]
            grads = [p.grad for p in ps]
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(grads, grads), alpha=1 - b2)
            for st in states:
                st["count"] += 1
            count = f32(states[0]["count"])
            bc1 = float(f32(1) - f32(b1) ** count)
            bc2 = float(f32(1) - f32(b2) ** count)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
            torch._foreach_add_(ps, upd, alpha=-group["lr"])
        return None


def make_optimizer(model: torch.nn.Module, lr: float = 1e-3, weight_decay: float = 5e-4,
                   total_steps: int = 10000, gamma: float = 0.1, optim_type: str = "Adam",
                   scheduler_type: str = "cosine", momentum: float = 0.0,
                   train_towers: bool = False
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer over the trainable parameters, schedule step -> LR)."""
    if scheduler_type == "cosine":
        sched = cosine_lr(lr, total_steps, gamma)
    else:
        def sched(step: int) -> float:
            return lr
    params = [p for n, p in model.named_parameters()
              if trainable_label(n, train_towers) == "train"]
    if optim_type.lower() in ("adam", "adamw"):
        opt = AdamW(params, lr=sched(0), weight_decay=weight_decay)
    elif optim_type.lower() == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"optim_type {optim_type}")
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """The model (which holds the weights), its optimizer and schedule, the
    optimizer steps taken and the loss configuration."""
    model: OryonModel
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    loss_cfg: FeatureLossConfig = FeatureLossConfig()
    step: int = 0

    @property
    def lr(self) -> float:
        """The LR of the next optimizer step."""
        return self.schedule(self.step)


def create_train_state(model: OryonModel, lr: float = 1e-3, weight_decay: float = 5e-4,
                       total_steps: int = 10000, gamma: float = 0.1,
                       loss_cfg: FeatureLossConfig = FeatureLossConfig(),
                       optim_type: str = "Adam", scheduler_type: str = "cosine",
                       momentum: float = 0.0) -> TrainState:
    """A fresh state on ``model`` as it is (initialise or load its weights
    first); the partition follows ``model.train_towers``."""
    opt, sched = make_optimizer(model, lr, weight_decay, total_steps, gamma, optim_type,
                                scheduler_type, momentum, train_towers=model.train_towers)
    return TrainState(model=model, optimizer=opt, schedule=sched, loss_cfg=loss_cfg)


def loss_and_metrics(model: OryonModel, loss_cfg: FeatureLossConfig, batch: PairBatch,
                     generator: Optional[torch.Generator] = None, mesh=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch.  ``batch.text_emb`` (the prompt cache)
    skips the text tower.  ``generator``: the loss's negative draws
    (``losses.feature_loss``; none when the featmap is the whole pool).

    ``mesh``: ``batch`` is this data rank's equal share of a global batch;
    the draws are made for the global batch and cut to the rank's rows, and
    the loss and metrics are the rank's shares of the global ones (they sum
    to them over ``data``)."""
    A, Q = batch.anchor, batch.query
    ids = None
    if batch.text_emb is None:   # ids may lie on the host (``collate(train=True)``)
        ids = torch.as_tensor(batch.prompt_ids, device=A.rgb.device)
    out = model(A.rgb, Q.rgb, ids, batch.text_emb)
    draws, group, n = None, None, 1
    if mesh is not None:
        group, n, r = mesh.data_group, mesh.shape["data"], mesh.data_rank
        B, N = batch.corrs.shape[:2]
        hw = tuple(out.featmap_a.shape[1:3])
        if not loss_cfg.hard_negatives or hw[0] * hw[1] > loss_cfg.neg_pool:
            if generator is None:
                raise ValueError("feature_loss draws indices: pass a generator")
            draws = tuple(d[r * B: (r + 1) * B]
                          for d in draw_indices(generator, hw, B * n, N, loss_cfg))
    lo = feature_loss(out.featmap_a, out.featmap_q, out.mask_a, out.mask_q, A.mask, Q.mask,
                      batch.corrs, batch.corr_valid, batch.valid, tuple(A.rgb.shape[1:3]),
                      generator, loss_cfg, draws=draws, group=group)
    metrics = {
        "loss/total": lo.total,
        "loss/mask": lo.losses["mask"],
        "loss/pos": lo.losses["pos"],
        "loss/neg": lo.losses["neg"],
        "metric/iou_a": torch.mean(lo.iou_a.float()) / n,
        "metric/iou_q": torch.mean(lo.iou_q.float()) / n,
    }
    return lo.total, metrics


def _slice(x, sl: slice):
    """Rows ``sl`` of every field of a (nested) NamedTuple batch."""
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_slice(f, sl) for f in x))
    return x[sl]


def _augment(batch: PairBatch, generator: torch.Generator, cfg: DeviceAugConfig, mesh,
             accum_steps: int) -> PairBatch:
    """``device_augment``; on a mesh the factors of the global batch, cut to
    this rank's rows."""
    if mesh is None:
        return device_augment(batch, generator, cfg)
    B = batch.corrs.shape[0] * mesh.shape["data"]
    rows = torch.as_tensor(mesh.batch_rows(B, accum_steps), device=generator.device)
    f = draw_factors(generator, B)
    return apply_factors(batch, AugFactors(*(t.index_select(1, rows) for t in f)), cfg)


def train_step(state: TrainState, batch: PairBatch, generator: Optional[torch.Generator] = None,
               aug_cfg: Optional[DeviceAugConfig] = None, accum_steps: int = 1,
               stage_events: Optional[list] = None, mesh=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``state`` (updated in place and returned) and
    the step's metrics as 0-d tensors on the device (read them only when
    needed: a read waits for the device).

    ``aug_cfg``: the augmentation stack, applied on the device with draws
    from ``generator``.  ``accum_steps``: micro-batches of B / accum_steps;
    the update applies the mean of their gradients.  ``stage_events``, a
    list, collects (stage, CUDA event) pairs at the boundaries of augment,
    forward + loss, backward and optimizer, for timing on the card.

    ``mesh``: data-parallel step; ``batch`` holds this rank's rows of the
    global batch (``parallel.mesh.shard_batch(batch, mesh, accum_steps)``),
    the metrics are the global batch's on every rank."""
    def mark(name):
        if stage_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stage_events.append((name, ev))

    B = batch.corrs.shape[0]
    if accum_steps < 1 or B % accum_steps:
        raise ValueError(f"batch size {B} not divisible by accum_steps {accum_steps}")
    model, opt = state.model, state.optimizer
    model.train()
    mark("start")
    if aug_cfg is not None:
        batch = _augment(batch, generator, aug_cfg, mesh, accum_steps)
    mark("augment")
    opt.zero_grad(set_to_none=True)
    n = B // accum_steps
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        micro = _slice(batch, slice(i * n, (i + 1) * n)) if accum_steps > 1 else batch
        loss, metrics = loss_and_metrics(model, state.loss_cfg, micro, generator, mesh)
        mark("forward")
        loss.backward()
        mark("backward")
        for k, v in metrics.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    if mesh is not None:
        # each rank's gradient is that of its share of the global loss
        all_reduce_coalesced_([p.grad for group in opt.param_groups for p in group["params"]
                               if p.grad is not None], mesh.data_group)
        keys = list(sums)
        total = all_reduce_(torch.stack([sums[k] for k in keys]), mesh.data_group)
        sums = dict(zip(keys, total.unbind()))
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(inv)
        sums = {k: v * inv for k, v in sums.items()}
    for group in opt.param_groups:
        group["lr"] = state.schedule(state.step)
    opt.step()
    mark("optimizer")
    state.step += 1
    return state, sums


def make_train_step(aug_cfg: Optional[DeviceAugConfig] = None, accum_steps: int = 1,
                    mesh=None):
    """``run(state, batch, generator) -> (state, metrics)``: ``train_step``
    on the batch's device fields with the augmentation, accumulation and
    mesh fixed (on a mesh, ``batch`` is the rank's rows)."""
    def run(state: TrainState, batch: PairBatch, generator: Optional[torch.Generator] = None,
            stage_events: Optional[list] = None):
        return train_step(state, device_fields(batch), generator, aug_cfg, accum_steps,
                          stage_events, mesh)

    return run
