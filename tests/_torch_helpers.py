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
