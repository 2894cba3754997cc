"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages: the JAX package (reference, on the CPU) and oryon_tpu_torch.
"""
from __future__ import annotations

import numpy as np


def flax_params(model, seed: int, *args, **kwargs):
    """A flax variable tree for ``model`` without tracing its forward pass
    for real: shapes from ``jax.eval_shape``, values from numpy in the
    manner of the flax initialisers (kernels N(0, 1/fan_in), small random
    biases, unit norm scales, BatchNorm stats 0/1, other leaves N(0, 0.02²))."""
    import jax

    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        name = names[-1]
        shape = leaf.shape
        core = shape[1:] if "resblocks" in names else shape   # scanned stacks
        if name == "kernel":
            std = float(np.prod(core[:-1])) ** -0.5
        elif name in ("scale", "var"):
            return np.ones(shape, np.float32)
        elif name == "mean":
            return np.zeros(shape, np.float32)
        else:
            std = 0.02
        return (rs.randn(*shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_torch(module, variables):
    """Load a flax tree into a port module through the weight bridge."""
    from oryon_tpu_torch.models.convert import from_jax_params

    module.load_state_dict(from_jax_params(variables), strict=True)
    return module.eval()


def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Geodesic angle (radians) between rotation stacks [..., 3, 3], from
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0, where
    the arccos of the trace loses half the digits of f32."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64),
                       axis=(-2, -1))
    return 2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


class pallas_interpret:
    """Run every ``pl.pallas_call`` inside the block in interpret mode, the
    way the JAX package's own tests reach its TPU kernels on the CPU."""

    def __enter__(self):
        import functools

        from jax.experimental import pallas as pl
        self.pl, self.orig = pl, pl.pallas_call
        pl.pallas_call = functools.partial(self.orig, interpret=True)

    def __exit__(self, *exc):
        self.pl.pallas_call = self.orig


def tiled_attention_model(q, k, v, scale: float, kmask=None, seg=None,
                          tile: int = 64, guard: bool = True):
    """Pure-PyTorch model of the arithmetic of the wgmma attention kernel
    (``oryon_tpu_torch/csrc/attn_wgmma.cuh``) on [B, H, L, D] torch tensors.

    Keys are walked in tiles of ``tile``; the logits are f32 sums of the
    input-dtype products, taken to log2 units by ``scale * log2(e)`` (the
    additive ``kmask`` [L] likewise, or ``seg`` [B, L] masks pairs of
    different segments with -inf); the running row max and row sum are f32;
    the weights ``exp2(s - m)`` are rounded to the input dtype before the
    P V product and the row sum adds the rounded values; O is rescaled by
    ``exp2(m_old - m_new)`` and normalised once at the end.  A row that has
    seen no live key yet subtracts 0 instead of its -inf max (``guard``), so
    its weights stay exactly 0 instead of exp2(-inf + inf) = NaN.
    """
    import math

    import torch

    B, H, L, D = q.shape
    log2e = math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(B, H, L, D)
    m_run = torch.full((B, H, L, 1), float("-inf"))
    l_run = torch.zeros(B, H, L, 1)
    for k0 in range(0, L, tile):
        k1 = min(k0 + tile, L)
        s = torch.einsum("bhld,bhmd->bhlm", qf, kf[:, :, k0:k1]) * (scale * log2e)
        if kmask is not None:
            s = s + (kmask.float()[k0:k1] * log2e)[None, None, None, :]
        if seg is not None:
            same = seg[:, :, None] == seg[:, None, k0:k1]
            s = s.masked_fill(~same[:, None], float("-inf"))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new) \
            if guard else m_new
        corr = torch.exp2(m_run - m_safe)
        p = torch.exp2(s - m_safe).to(q.dtype)
        l_run = l_run * corr + p.float().sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhlm,bhmd->bhld", p.float(), vf[:, :, k0:k1])
        m_run = m_new
    return (o / l_run).to(q.dtype)


def tiled_attention_model_packed(qkv, kmask, heads: int, scale: float, **kw):
    """``tiled_attention_model`` on the lane-packed [B, L, 3C] layout of K1."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    out = tiled_attention_model(q, k, v, scale, kmask=kmask, **kw)
    return out.transpose(1, 2).reshape(B, L, C)
