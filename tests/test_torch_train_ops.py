"""Parity of the PyTorch port's optimizer, LR schedule and attention-kernel
gradients with the JAX package, on the CPU.

Tolerances: optimizer steps on the same gradients within 1e-6 of each
leaf's largest value (float32 arithmetic in both, optax's order); the LR
schedule within 1e-7 relative (both in float32); K1's gradient within 1e-5
at f32 (the same plain attention differentiated in two packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import pallas_interpret
from test_torch_train import _leaves_close, _models, _torch_tree


def test_k1_gradient_matches_jax_vjp():
    """K1's ``MhaLanesFunction`` against ``jax.vjp`` of the JAX kernel (its
    ``custom_vjp``, the kernel in interpret mode): d qkv and d kmask within
    1e-5 at f32; with ``qk_int8`` the gradient is straight through, the
    same as without."""
    from oryon_tpu.ops.pallas.mha_lanes import fused_mha_lanes_qkv as jax_k1
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    rs = np.random.RandomState(6)
    B, L, H, hd = 2, 128, 2, 16
    qkv = rs.randn(B, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < 100, 0.0, -1e9).astype(np.float32)
    g = rs.randn(B, L, H * hd).astype(np.float32)
    with pallas_interpret():
        _, vjp = jax.vjp(lambda x, m: jax_k1(x, m, H, hd ** -0.5), jnp.asarray(qkv),
                         jnp.asarray(kmask))
        dq_ref, dm_ref = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    m = torch.from_numpy(kmask).requires_grad_()
    dq, dm = torch.autograd.grad(fused_mha_lanes_qkv(x, m, H, hd ** -0.5), (x, m),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dm.numpy(), np.asarray(dm_ref), atol=1e-5, rtol=1e-5)
    xb = x.detach().bfloat16().requires_grad_()
    d8, d16 = (torch.autograd.grad(fused_mha_lanes_qkv(xb, m.detach(), H, hd ** -0.5, i8),
                                   xb, torch.from_numpy(g).bfloat16())[0]
               for i8 in (True, False))
    assert torch.equal(d8, d16)


@pytest.mark.parametrize("optim,momentum", [("AdamW", 0.0), ("SGD", 0.9)])
def test_optimizer_steps_match_optax(optim, momentum):
    """Two steps on the same gradients: trainable leaves as optax's
    partitioned AdamW / decayed-weights + momentum SGD give them, frozen
    leaves untouched and without optimizer state."""
    from oryon_tpu.train import make_optimizer as jax_make
    from oryon_tpu_torch.train import make_optimizer, trainable_label

    import optax

    _, params, _, tm = _models(False)
    kw = dict(lr=1e-2, weight_decay=5e-2, total_steps=3, gamma=0.1, optim_type=optim,
              momentum=momentum)
    tx = jax_make(params, **kw)
    opt, sched = make_optimizer(tm, **kw)
    rs = np.random.RandomState(2)
    state, p = tx.init(params), params
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for step in range(2):
        g = jax.tree_util.tree_map(lambda x: jnp.asarray(
            rs.randn(*x.shape).astype(np.float32) * 0.01), params)
        updates, state = update(g, state, p)
        p = optax.apply_updates(p, updates)
        tg = _torch_tree(g)
        for n, t in tm.named_parameters():
            t.grad = torch.from_numpy(tg[n].copy())
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
    ref, before = _torch_tree(p), _torch_tree(params)
    now = {n: t.detach().numpy() for n, t in tm.named_parameters()}
    _leaves_close(now, ref, 1e-6, 0.0)
    for n, t in tm.named_parameters():
        if trainable_label(n) == "frozen":
            np.testing.assert_array_equal(now[n], before[n], err_msg=n)
            assert t not in opt.state
    assert sum(len(g["params"]) for g in opt.param_groups) == sum(
        trainable_label(n) == "train" for n, _ in tm.named_parameters())


def test_cosine_lr_matches_optax_schedule():
    from oryon_tpu.train import cosine_lr as jax_cosine
    from oryon_tpu_torch.train import cosine_lr

    for total in (1, 2, 7, 1000):
        ref, got = jax_cosine(1e-3, total, 0.1), cosine_lr(1e-3, total, 0.1)
        for step in list(range(min(total, 12) + 3)) + [total - 1, total, total + 5]:
            assert got(step) == pytest.approx(float(ref(step)), rel=1e-7), (total, step)


def test_flash_and_window_kernels_refuse_gradients_as_in_jax():
    """K5, K3 and K4 take no gradient in the port, on the CPU as on the card,
    because the JAX package cannot differentiate them: its flash wrapper sets
    no backward block sizes (the stock kernel raises) and its window kernels
    have no ``custom_vjp``.  Both sides are shown here, the JAX side by
    ``jax.eval_shape`` of ``jax.grad`` (about a second)."""
    from oryon_tpu.ops.flash import flash_mha as jax_flash
    from oryon_tpu.ops.pallas.swin_attn import band_window_attention as jax_band
    from oryon_tpu.ops.pallas.swin_attn import packed_window_attention as jax_packed
    from oryon_tpu_torch.ops.cuda import flash, swin_attn

    f32 = jnp.float32
    q4 = jax.ShapeDtypeStruct((1, 2, 128, 16), f32)
    qw = jax.ShapeDtypeStruct((2, 49, 32), f32)
    bias = jax.ShapeDtypeStruct((1, 1, 49, 49), f32)
    cases = [(lambda q: jax_flash(q, q, q, 0.25).sum(), (q4,)),
             (lambda q, b: jax_packed(q, q, q, b, 1, 1, 0.2).sum(), (qw, bias)),
             (lambda m, b: jax_band(m, b, 1, 7, 0.2).sum(),
              (jax.ShapeDtypeStruct((1, 7, 7, 96), f32), bias))]
    for fn, args in cases:
        jax.eval_shape(fn, *args)                    # the forward traces
        with pytest.raises(Exception):
            jax.eval_shape(jax.grad(fn), *args)

    q = torch.randn(1, 2, 128, 16, requires_grad=True)
    w = torch.randn(2, 49, 32, requires_grad=True)
    m = torch.randn(1, 7, 7, 96, requires_grad=True)
    b = torch.zeros(1, 1, 49, 49)
    outs = [flash.flash_mha(q, q, q, 0.25),                    # a forward pass is allowed
            swin_attn.packed_window_attention(w, w, w, b, 1, 0.2),
            swin_attn.band_window_attention(m, b, 1, 7, 0.2)]
    for out, name in zip(outs, ("K5", "K3", "K4")):
        assert out.requires_grad
        with pytest.raises(RuntimeError, match=f"{name}.*cannot be differentiated.*"
                                               "attn_impl=fused"):
            out.sum().backward()
    assert q.grad is None and w.grad is None and m.grad is None
