"""Train the PointDSC registration solver on synthetic problems.

Counterpart of ``scripts/train_pointdsc.py``: the same problems (a random
rigid transform, a matched cloud corrupted by a controlled outlier fraction
and noise, some problems padded), the same losses (BCE of the confidence
logits against the ground-truth inlier labels, plus the spectral-matching
loss with the module's learnable ``sigma``), Adam with optax's float32
arithmetic, BatchNorm on each problem's statistics, and a held-out check of
the whole solver on 16 fresh problems.

    python -m oryon_tpu_torch.scripts.train_pointdsc steps=3000 batch=8 n=256 \
        out=pretrained_models/pointdsc [--device cpu]

Writes ``<out>/native.npz`` in the flax layout ('/'-joined ``params/...``
and ``batch_stats/...`` paths, Dense kernels [in, out]), which the
``build_pointdsc_solver`` of both packages load.
"""
from __future__ import annotations

import os
import sys
import time
import types

import numpy as np


def make_problem(rng: np.random.RandomState, n: int):
    """One synthetic registration problem -> (src, tgt, valid, inlier, [R | t])."""
    scale = rng.uniform(0.1, 0.4)
    src = (rng.rand(n, 3) - 0.5) * scale
    # random rotation via quaternion, full range
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    t = rng.randn(3) * 0.3
    inlier_rate = rng.uniform(0.15, 0.9)
    inlier = (rng.rand(n) < inlier_rate).astype(np.float32)
    noise = rng.randn(n, 3) * rng.uniform(0.001, 0.005)
    tgt_in = src @ R.T + t + noise
    # outliers: random points in the transformed scene volume
    tgt_out = ((rng.rand(n, 3) - 0.5) * scale) @ R.T + t
    tgt = np.where(inlier[:, None] > 0, tgt_in, tgt_out)
    # a few problems carry padding, as the pipeline's fixed-capacity buffers
    valid = np.ones(n, np.float32)
    if rng.rand() < 0.3:
        valid[rng.randint(n // 2, n):] = 0.0
    inlier = inlier * valid
    return (src.astype(np.float32), tgt.astype(np.float32), valid, inlier,
            np.concatenate([R, t[:, None]], 1).astype(np.float32))


def make_batch(rng, b: int, n: int):
    cols = [make_problem(rng, n) for _ in range(b)]
    return tuple(np.stack([c[i] for c in cols]) for i in range(5))


def problem_losses(model, src, tgt, valid, inlier):
    """Per problem: (BCE + SM, BCE, SM, confidence logits [B, N])."""
    import torch
    import torch.nn.functional as F

    from oryon_tpu_torch.geometry.pcd import sq_dist_matrix

    logits, fn = model(src, tgt, valid, train=True)
    v = valid
    nv = torch.clamp(v.sum(-1), min=1.0)
    # optax.sigmoid_binary_cross_entropy, over the valid rows
    bce = -inlier * F.logsigmoid(logits) - (1.0 - inlier) * F.logsigmoid(-logits)
    bce = (bce * v).sum(-1) / nv
    # spectral matching with the module's learnable sigma
    sigma = model.sigma[0]
    sim = torch.einsum("bnc,bmc->bnm", fn, fn)
    df2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    m_feat = F.relu(1.0 - df2 / (sigma ** 2 + 1e-6))
    sd = torch.sqrt(sq_dist_matrix(src, src) + 1e-12)
    td = torch.sqrt(sq_dist_matrix(tgt, tgt) + 1e-12)
    compat = torch.clamp(1.0 - (sd - td) ** 2 / model.cfg.sigma_d ** 2, min=0.0)
    off = 1.0 - torch.eye(v.shape[1], device=v.device)
    vv = v[:, :, None] * v[:, None, :] * off
    m = m_feat * compat * vv
    m_gt = inlier[:, :, None] * inlier[:, None, :] * vv
    sm = ((m - m_gt) ** 2 * vv).sum((1, 2)) / torch.clamp(vv.sum((1, 2)), min=1.0)
    return bce + sm, bce, sm, logits


def train_step(model, optimizer, src, tgt, valid, inlier):
    """One Adam step on the mean loss over the problems; returns (loss, BCE,
    SM, inlier accuracy at logit 0) as 0-d tensors."""
    import torch

    optimizer.zero_grad(set_to_none=True)
    loss, bce, sm, logits = problem_losses(model, src, tgt, valid, inlier)
    loss.mean().backward()
    optimizer.step()
    with torch.no_grad():
        pred = (logits > 0).float()
        acc = ((pred == inlier).float() * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return torch.stack([loss.mean(), bce.mean(), sm.mean(), acc]).detach()


def train(model, steps: int, batch: int, n: int, lr: float, seed: int, device,
          log=print) -> types.SimpleNamespace:
    """``steps`` steps on batches drawn from ``RandomState(seed + 1)``.
    Returns the per-step [loss, BCE, SM, accuracy] rows and each step's host
    seconds (the card synchronised after each step)."""
    import torch

    from oryon_tpu_torch.train import AdamW

    model.to(device).train()
    optimizer = AdamW(model.parameters(), lr=lr, weight_decay=0.0)   # optax.adam
    rng = np.random.RandomState(seed + 1)
    rows, step_s = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        src, tgt, valid, inlier, _ = (torch.as_tensor(a, device=device)
                                      for a in make_batch(rng, batch, n))
        rows.append(train_step(model, optimizer, src, tgt, valid, inlier))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        if step % 100 == 0 or step == steps - 1:
            l, bce, sm, acc = rows[-1].tolist()
            log(f"step {step}: loss {l:.4f} bce {bce:.4f} sm {sm:.4f} inlier-acc {acc:.3f}")
            sys.stdout.flush()
    model.eval()
    return types.SimpleNamespace(history=torch.stack(rows).cpu().numpy(),
                                 step_s=np.asarray(step_s))


def held_out(model, n: int, device):
    """Rotation (deg) and translation (cm) errors of the whole solver on the
    16 problems of ``RandomState(999)``."""
    import torch

    from oryon_tpu_torch.models.pointdsc import batched_pointdsc

    src, tgt, valid, _, gt = make_batch(np.random.RandomState(999), 16, n)
    T, _, _ = batched_pointdsc(model)(*(torch.as_tensor(a, device=device)
                                        for a in (src, tgt, valid)))
    T = T.cpu().numpy()
    r_errs, t_errs = [], []
    for i in range(T.shape[0]):
        Rp, tp = T[i, :3, :3], T[i, :3, 3]
        Rg, tg = gt[i, :, :3], gt[i, :, 3]
        cosang = (np.trace(Rp.T @ Rg) - 1.0) / 2.0
        r_errs.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        t_errs.append(np.linalg.norm(tp - tg) * 100.0)
    return np.asarray(r_errs), np.asarray(t_errs)


def main(argv) -> types.SimpleNamespace:
    """Returns the run: the trained ``model``, ``history`` [steps, 4],
    ``step_s``, the held-out ``r_errs`` / ``t_errs`` and the written ``path``."""
    import torch

    from oryon_tpu_torch.models.convert import save_flax_npz, to_jax_params
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.pipeline import pointdsc_native_path
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import overrides

    args = dict(a.split("=", 1) for a in overrides(argv))
    steps = int(args.get("steps", 3000))
    batch = int(args.get("batch", 8))
    n = int(args.get("n", 256))
    lr = float(args.get("lr", 1e-4))
    seed = int(args.get("seed", 0))
    out = args.get("out", "pretrained_models/pointdsc")
    device = _device(argv)

    cfg = PointDSCConfig(num_layers=int(args.get("layers", 6)))
    model = random_init_(PointDSC(cfg), torch.Generator().manual_seed(seed))
    run = train(model, steps, batch, n, lr, seed, device)
    r_errs, t_errs = held_out(model, n, device)
    print(f"held-out (16 problems): R err mean {np.mean(r_errs):.3f} deg "
          f"median {np.median(r_errs):.3f}; T err mean {np.mean(t_errs):.3f} cm", flush=True)

    os.makedirs(out, exist_ok=True)
    path = pointdsc_native_path(out)
    save_flax_npz(path, to_jax_params(model.state_dict()))
    print(f"wrote {path}")
    vars(run).update(model=model, r_errs=r_errs, t_errs=t_errs, path=path)
    return run


if __name__ == "__main__":
    main(sys.argv[1:])
