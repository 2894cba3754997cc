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


def quantise_model(q, k, scale: float):
    """Model of K1-i8's pre-pass on [B, H, L, D] torch tensors: (qm, km
    [B, H, 1, 1] f32, qi, ki int8).  Two f32 multiplies in the reference's
    order, (x * scale) * (127 / max) with a true division, then round half
    to even (numpy's ``rint``), as the quantising kernel does."""
    import torch

    qf = (q.float() * scale).numpy()
    kf = k.float().numpy()
    out = []
    for x in (qf, kf):
        m = np.maximum(np.abs(x).max(axis=(-2, -1), keepdims=True), np.float32(1e-12))
        codes = np.rint(x * (np.float32(127.0) / m)).astype(np.int8)
        out.append((torch.from_numpy(m), torch.from_numpy(codes)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


MAGIC_BITS, MAGIC = 0x4B400000, 12582912.0   # attn_wgmma.cuh: kMagicBits, kMagic


def tiled_attention_model(q, k, v, scale: float, kmask=None, seg=None,
                          tile: int = 64, guard: bool = True, qk_int8: bool = False):
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

    ``qk_int8`` (K1-i8, with ``kmask``): the logits come from the codes of
    ``quantise_model``; a tile's int32 sums become floats by adding the bits
    of 1.5 * 2**23 (the float 12582912 + n, exactly) and are descaled by
    ``qm * km / 127**2 * log2(e)`` in one fused multiply-add whose addend is
    the mask less 12582912 times the descale (modelled in f64: the product
    of two f32 values is exact there, and the one rounding to f32 follows).
    """
    import math

    import torch

    B, H, L, D = q.shape
    log2e = math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    if qk_int8:
        qm, km, qi, ki = quantise_model(q, k, scale)
        mul = (qm * km) / torch.tensor(127.0 * 127.0) * torch.tensor(log2e)   # f32
    o = torch.zeros(B, H, L, D)
    m_run = torch.full((B, H, L, 1), float("-inf"))
    l_run = torch.zeros(B, H, L, 1)
    for k0 in range(0, L, tile):
        k1 = min(k0 + tile, L)
        if qk_int8:
            si = torch.einsum("bhld,bhmd->bhlm", qi.int(), ki[:, :, k0:k1].int())
            x = (si + MAGIC_BITS).view(torch.float32)
            assert torch.equal(x.double(), si.double() + MAGIC)
            add = (kmask.double()[k0:k1] * log2e - MAGIC * mul.double()).float()
            s = (x.double() * mul.double() + add.double()).float()
        else:
            s = torch.einsum("bhld,bhmd->bhlm", qf, kf[:, :, k0:k1]) * (scale * log2e)
        if kmask is not None and not qk_int8:
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


class StubLib:
    """Stands in for the kernel library: records which C entry point a
    wrapper called and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, len(args)))
            return 0
        return entry


def tiled_attention_model_packed(qkv, kmask, heads: int, scale: float, **kw):
    """``tiled_attention_model`` on the lane-packed [B, L, 3C] layout of K1."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    out = tiled_attention_model(q, k, v, scale, kmask=kmask, **kw)
    return out.transpose(1, 2).reshape(B, L, C)


def compact_model(tgt, bad):
    """Model of the pre-pass of K2's bf16 kernel (``csrc/match_wgmma.cuh``)
    for one pair, in numpy: a running count of the kept targets gives each
    its position (order preserved).  Returns (tgt16 [count, D] bf16 torch
    tensor, idx_map [count] int32, count)."""
    import torch

    keep = ~np.asarray(bad, bool)
    pos = np.cumsum(keep) - 1
    count = int(keep.sum())
    idx_map = np.zeros(count, np.int32)
    idx_map[pos[keep]] = np.arange(len(keep), dtype=np.int32)[keep]
    return torch.from_numpy(np.asarray(tgt, np.float32))[idx_map.astype(np.int64)].bfloat16(), \
        idx_map, count


def tiled_argmin_model(src, tgt, bad, tile: int = 128, splits: int = 1):
    """Pure-PyTorch model of the arithmetic of K2's bf16 kernel for one pair
    (src [S, D], tgt [N, D] f32 numpy, bad [N] bool): compacted targets in
    tiles of ``tile``; f32 sums of bf16-rounded inputs; each of the four
    lanes that share a row owns the columns ``j * 8 + 2 * lane + {0, 1}`` of
    a tile, tracks the maximum of the sum over them with a strict ``>`` from
    tile to tile and, inside a winning tile, the first of its columns that
    holds the maximum; the last tile bounds its columns; the lanes merge at
    the end (larger sum, then lower position); the pair's tiles are cut into
    ``splits`` ranges that each start from -inf and are merged in order, a
    later range winning only with a larger sum; the distance
    ``0.5 * (1 - sum)`` is formed once a row and the position goes through
    the index map.  A pair with no kept target gives (+inf, 0)."""
    import torch

    t16, idx_map, count = compact_model(tgt, bad)
    s16 = torch.from_numpy(np.asarray(src, np.float32)).bfloat16().float()
    S = s16.shape[0]
    lane_cols = torch.tensor([[j * 8 + 2 * lane + e for j in range(tile // 8) for e in (0, 1)]
                              for lane in range(4)])          # [4, tile / 4], increasing
    n_tiles = -(-count // tile)
    row_best = torch.full((S,), float("-inf"))
    pos = torch.zeros(S, dtype=torch.int64)
    for split in range(splits):
        best = torch.full((S, 4), float("-inf"))
        barg = torch.zeros((S, 4), dtype=torch.int64)
        for t in range(n_tiles * split // splits, n_tiles * (split + 1) // splits):
            t0 = t * tile
            sums = torch.full((S, tile), float("-inf"))
            live = min(tile, count - t0)
            sums[:, :live] = s16 @ t16[t0:t0 + live].float().T
            per_lane = sums[:, lane_cols]                            # [S, 4, tile / 4]
            tmax, first = per_lane.max(dim=-1)                       # first index on ties
            wins = tmax > best
            best = torch.where(wins, tmax, best)
            barg = torch.where(wins, t0 + lane_cols[torch.arange(4)[None, :], first], barg)
        split_best = best.amax(dim=1)
        split_pos = torch.where(best == split_best[:, None], barg,
                                torch.iinfo(torch.int64).max).amin(dim=1)
        wins = split_best > row_best
        row_best = torch.where(wins, split_best, row_best)
        pos = torch.where(wins, split_pos, pos)
    dist = 0.5 * (1.0 - row_best)
    if count == 0:
        return dist, torch.zeros(S, dtype=torch.int32)
    return dist, torch.from_numpy(idx_map)[pos]
