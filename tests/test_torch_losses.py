"""Parity of the PyTorch port's losses and device augmentation with the
JAX package, on the same numpy-seeded inputs.

Tolerances: the mask losses within 1e-6 (f32 reductions of a few hundred
terms); the feature loss's total and parts within 1e-5 relative (f32 sums
over pools of up to 2048 candidates, two packages' summation orders); the
augmented images within 1e-6 on the same factors (f32 colour maps of values
in [0, 1]); masks, depths and correspondences exactly (pure mirrors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

KEY = jax.random.PRNGKey(3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["dice", "cross_entropy", "focal", "lovasz"])
def test_mask_losses_match_jax(name):
    from oryon_tpu.losses.mask_losses import MASK_LOSSES as JAX_LOSSES
    from oryon_tpu_torch.losses.mask_losses import MASK_LOSSES

    rs = np.random.RandomState(1)
    x = (rs.randn(3, 12, 10) * 2).astype(np.float32)
    t = (rs.rand(3, 12, 10) > 0.6).astype(np.float32)
    want = float(JAX_LOSSES[name](jnp.array(x), jnp.array(t)))
    got = float(MASK_LOSSES[name](_t(x), _t(t)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def _loss_inputs(rs, B=2, H=24, W=20, D=16, N=40, in_hw=(56, 48)):
    fa = rs.randn(B, H, W, D).astype(np.float32)
    fq = rs.randn(B, H, W, D).astype(np.float32)
    fq[:, :12] = fa[:, :12] + 0.1 * rs.randn(B, 12, W, D).astype(np.float32)
    corrs = np.stack([rs.randint(0, in_hw[0], (B, N)), rs.randint(0, in_hw[1], (B, N)),
                      rs.randint(0, in_hw[0], (B, N)), rs.randint(0, in_hw[1], (B, N))],
                     -1).astype(np.int32)
    corrs[0, :5] = [[in_hw[0] - 1, in_hw[1] - 1, 0, in_hw[1] - 1]] * 5   # clamp edges
    cv = rs.rand(B, N) > 0.2
    sv = np.array([1.0, 0.0] + [1.0] * (B - 2), np.float32)
    ml_a = rs.randn(B, H, W).astype(np.float32)
    ml_q = rs.randn(B, H, W).astype(np.float32)
    gm_a = (rs.rand(B, *in_hw) > 0.5).astype(np.uint8)
    gm_q = (rs.rand(B, *in_hw) > 0.5).astype(np.uint8)
    return fa, fq, ml_a, ml_q, gm_a, gm_q, corrs, cv, sv, in_hw


# (hard negatives, pool size): the whole featmap (480 px <= 2048) as the
# pool, a drawn pool of 100, and one random negative a positive
CASES = [(True, 2048, "dice"), (True, 100, "focal"), (False, 2048, "lovasz")]


@pytest.mark.parametrize("hard,pool,mask_type", CASES)
def test_feature_loss_matches_jax(hard, pool, mask_type):
    from oryon_tpu.losses.feature_loss import FeatureLossConfig as JCfg
    from oryon_tpu.losses.feature_loss import feature_loss as jax_loss
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig, feature_loss

    rs = np.random.RandomState(4)
    fa, fq, ml_a, ml_q, gm_a, gm_q, corrs, cv, sv, in_hw = _loss_inputs(rs)
    B, H, W, _ = fa.shape
    N = corrs.shape[1]
    kw = dict(neg_pool=pool, hard_negatives=hard, mask_type=mask_type)
    want = jax_loss(*(jnp.array(a) for a in (fa, fq, ml_a, ml_q, gm_a, gm_q, corrs, cv, sv)),
                    in_hw, KEY, JCfg(**kw))
    # the JAX package's draws, from the same key in the same order
    ka, kq = jax.random.split(KEY)
    draws = None
    if not hard or H * W > pool:
        shape = (B, pool) if hard else (B, N)
        draws = tuple(_t(jax.random.randint(k, shape, 0, H * W)).long() for k in (ka, kq))
    got = feature_loss(*(_t(a) for a in (fa, fq, ml_a, ml_q, gm_a, gm_q, corrs, cv, sv)),
                       in_hw, None, FeatureLossConfig(**kw), draws=draws)
    assert float(got.total) == pytest.approx(float(want.total), rel=1e-5)
    for k in ("mask", "pos", "neg"):
        assert float(got.losses[k]) == pytest.approx(float(want.losses[k]), rel=1e-5), k
    np.testing.assert_array_equal(got.pred_mask_a.numpy(), np.asarray(want.pred_mask_a))
    np.testing.assert_allclose(got.iou_q.numpy(), np.asarray(want.iou_q), rtol=1e-6)


def test_feature_loss_draws_from_a_generator():
    """Without ``draws`` a drawn pool comes from the generator: the same
    seed gives the same loss, another seed another one; a missing generator
    raises."""
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig, feature_loss

    args = [_t(a) for a in _loss_inputs(np.random.RandomState(4))[:-1]]
    in_hw = (56, 48)
    cfg = FeatureLossConfig(neg_pool=50)

    def run(seed):
        return float(feature_loss(*args, in_hw, torch.Generator().manual_seed(seed), cfg).total)

    assert run(0) == run(0) and run(0) != run(1)
    with pytest.raises(ValueError, match="generator"):
        feature_loss(*args, in_hw, None, cfg)


def _jax_factors(key, B, cfg):
    """The factors the JAX package's ``device_augment`` draws from ``key``,
    in its order (views split first, then per view: jitter, bright, gates)."""
    keys = jax.random.split(key, 2 * B).reshape(2, B, -1)
    gates, jit, order, bright = [], [], [], []
    lims = ((0.875, 1.125), (0.5, 1.5), (0.5, 1.5), (-0.05, 0.05))
    for s in range(2):
        for b in range(B):
            kj, kb, kg = jax.random.split(keys[s, b], 3)
            gates.append(np.asarray(jax.random.uniform(kg, (4,))))
            ks = jax.random.split(kj, 5)
            jit.append([float(jax.random.uniform(k, (), minval=lo, maxval=hi))
                        for k, (lo, hi) in zip(ks[:4], lims)])
            order.append(np.asarray(jax.random.permutation(ks[4], 4)))
            bright.append(float(jax.random.uniform(jax.random.split(kb, 5)[0], (),
                                                   minval=0.75, maxval=1.25)))
    from oryon_tpu_torch.data.device_augment import AugFactors
    return AugFactors(_t(np.stack(gates)).reshape(2, B, 4).float(),
                      _t(np.array(jit, np.float32)).reshape(2, B, 4),
                      _t(np.stack(order)).reshape(2, B, 4).long(),
                      _t(np.array(bright, np.float32)).reshape(2, B))


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_device_augment_matches_jax(prob):
    from oryon_tpu.data import device_augment as jdev
    from oryon_tpu.data.pair_batch import device_fields
    from oryon_tpu.data.synthetic import synthetic_pair_batch as jax_batch
    from oryon_tpu_torch.data import device_augment as dev
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch

    B = 6
    kw = dict(seed=5, batch=B, img_hw=(32, 40), orig_hw=(96, 128), n_corrs=24)
    cfg = dev.DeviceAugConfig(prob=prob)
    want = jax.jit(jdev.device_augment, static_argnames=("cfg",))(
        device_fields(jax_batch(**kw)), KEY, jdev.DeviceAugConfig(prob=prob))
    got = dev.apply_factors(synthetic_pair_batch(**kw), _jax_factors(KEY, B, cfg), cfg)
    for side in ("anchor", "query"):
        g, w = getattr(got, side), getattr(want, side)
        assert g.rgb.dtype == torch.float32
        np.testing.assert_allclose(g.rgb.numpy(), np.asarray(w.rgb), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_array_equal(g.depth.numpy(), np.asarray(w.depth).astype(np.float32))
    np.testing.assert_array_equal(got.corrs.numpy(), np.asarray(want.corrs))


def test_device_augment_draws_and_mirrors():
    """``device_augment`` draws from its generator (same seed, same result);
    at prob 1 every view is flipped both ways and its correspondences with
    it; at prob 0 the stack is the identity."""
    from oryon_tpu_torch.data import device_augment as dev
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch

    batch = synthetic_pair_batch(seed=2, batch=3, img_hw=(16, 20), orig_hw=(64, 80),
                                 n_corrs=8)
    a = dev.device_augment(batch, torch.Generator().manual_seed(1), dev.DeviceAugConfig())
    b = dev.device_augment(batch, torch.Generator().manual_seed(1), dev.DeviceAugConfig())
    assert torch.equal(a.anchor.rgb, b.anchor.rgb) and torch.equal(a.corrs, b.corrs)
    flips = dev.DeviceAugConfig(jitter=False, bright=False, prob=1.0)
    f = dev.device_augment(batch, torch.Generator().manual_seed(1), flips)
    assert torch.equal(f.anchor.mask, batch.anchor.mask.flip(1, 2))
    assert torch.equal(f.corrs[..., 0], 15 - batch.corrs[..., 0])
    assert torch.equal(f.corrs[..., 3], 19 - batch.corrs[..., 3])
    same = dev.device_augment(batch, torch.Generator().manual_seed(1),
                              dev.DeviceAugConfig(prob=0.0))
    assert torch.equal(same.anchor.rgb, batch.anchor.rgb.float() / 255.0)
    assert torch.equal(same.corrs, batch.corrs)
