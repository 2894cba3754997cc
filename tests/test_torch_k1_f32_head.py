"""K1's f32 mode and its backward at the small and tiny towers' shapes, on
the CPU: the models of the one-block-a-head kernels' arithmetic
(``tests/_torch_helpers.py::k1_f32_head_model``, ``k1_bwd_f32_head_model``)
against the JAX package, which kernel serves which shape, and the backward's
d kmask reduction.

The JAX side of the forward is ``oryon_tpu/ops/pallas/mha_lanes.py::
fused_mha_lanes_qkv`` in interpret mode; that kernel asserts L a multiple of
128, so a shorter sequence is padded to 128 with keys masked at -1e9 (their
weights are exactly 0 in f32) and its first L rows are compared.  The
backward's is ``_bwd`` itself (``jax.vjp`` of ``_reference_mha``), which
takes any L.  Tolerance 1e-5 (f32 on both sides, sums in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (StubLib, k1_bwd_f32_head_model, k1_f32_head_model,
                            last_block_sum, pallas_interpret)

# L, head dim, images, heads: the tiny and small towers' L (17, 65), a single
# key, the longest L a block holds; B * heads of 1 and of 12
CASES = [(L, hd, B, H) for L in (1, 17, 65, 128) for hd, B, H in ((16, 3, 4), (32, 1, 1))]


def _inputs(L, hd, B, H, seed):
    """qkv [B, L, 3C], kmask [L] with the last fifth of the keys at -1e9,
    dout [B, L, C]; f32 numpy from a seed."""
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < L - L // 5, 0.0, -1e9).astype(np.float32)
    return qkv, kmask, rs.randn(B, L, H * hd).astype(np.float32)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("L,hd,B,H", CASES)
def test_forward_model_matches_the_jax_kernel(L, hd, B, H):
    """The model of the forward kernel (exact row max, division last)
    against the Pallas kernel in interpret mode at f32, masked keys."""
    from oryon_tpu.ops.pallas import mha_lanes as jax_k1

    qkv, kmask, _ = _inputs(L, hd, B, H, seed=L + hd)
    pad = np.zeros((B, 128 - L, qkv.shape[-1]), np.float32)
    mask = np.concatenate([kmask, np.full(128 - L, -1e9, np.float32)])
    with pallas_interpret():
        ref = jax_k1.fused_mha_lanes_qkv(jnp.asarray(np.concatenate([qkv, pad], 1)),
                                         jnp.asarray(mask), H, hd ** -0.5)
    got = k1_f32_head_model(torch.from_numpy(qkv), torch.from_numpy(kmask), H, hd ** -0.5)
    _close(got.numpy(), np.asarray(ref)[:, :L], "out")


@pytest.mark.parametrize("L,hd,B,H", CASES)
def test_backward_model_matches_jax_vjp(L, hd, B, H):
    """The model of the backward kernel (the five products, the slab summed
    in index order) against the JAX ``_bwd``: d qkv and d kmask, masked
    keys."""
    from oryon_tpu.ops.pallas import mha_lanes as jax_k1

    qkv, kmask, g = _inputs(L, hd, B, H, seed=2 * L + hd)
    dq_ref, dm_ref = jax_k1._bwd(H, hd ** -0.5, True, False,
                                 (jnp.asarray(qkv), jnp.asarray(kmask)), jnp.asarray(g))
    dq, slab, dm = k1_bwd_f32_head_model(*(torch.from_numpy(a) for a in (qkv, kmask, g)), H,
                                         hd ** -0.5)
    assert slab.shape == (B * H, L)
    _close(dq.numpy(), np.asarray(dq_ref), "d qkv")
    _close(dm.numpy(), np.asarray(dm_ref), "d kmask")


def test_last_block_sum_is_the_same_in_any_finish_order():
    """Whichever block finishes last sums the slab's rows in index order, so
    d kmask is bitwise the same for every order the blocks finish in, and
    the counter is back at 0 after the launch."""
    rs = np.random.RandomState(3)
    slab = torch.from_numpy(rs.randn(12, 65).astype(np.float32) * 10.0 ** rs.randint(
        -3, 4, size=(12, 1)).astype(np.float32))
    first, counter = last_block_sum(slab, range(12))
    assert counter == 0 and torch.isfinite(first).all()
    for seed in range(8):
        total, counter = last_block_sum(slab, np.random.RandomState(seed).permutation(12))
        assert counter == 0 and torch.equal(total, first)
    _, _, dm = k1_bwd_f32_head_model(*(torch.from_numpy(a) for a in _inputs(17, 16, 3, 4, 1)),
                                     4, 0.25, order=np.random.RandomState(9).permutation(12))
    _, _, dm0 = k1_bwd_f32_head_model(*(torch.from_numpy(a) for a in _inputs(17, 16, 3, 4, 1)),
                                      4, 0.25)
    assert torch.equal(dm, dm0)


# (head dim, L) -> the forward's and the backward's entry
ROUTES = [(16, 1, True), (16, 17, True), (16, 65, True), (32, 128, True), (16, 129, False),
          (32, 577, False), (64, 65, False), (128, 17, False)]


@pytest.mark.parametrize("hd,L,head", ROUTES)
def test_f32_wrapper_chooses_the_kernel_by_shape(hd, L, head):
    """An f32 qkv with L <= 128 at head dims 16 and 32 goes to the
    one-block-a-head entries, anything longer or wider to the streaming
    forward and the two-kernel backward; each call passes its signature's
    arguments and counts one launch."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    fwd = "oryon_fused_mha_lanes_f32" + ("_head" if head else "")
    bwd = mha_lanes.BWD_F32_HEAD if head else "oryon_mha_lanes_bwd_f32"
    assert mha_lanes.kernel_entry(hd, False, torch.float32, L) == fwd
    assert mha_lanes.backward_entry(hd, torch.float32, L) == bwd
    stub = StubLib()
    qkv, kmask = torch.zeros(1, L, 3 * 2 * hd), torch.zeros(L)
    before = (mha_lanes.launches, mha_lanes.launches_bwd)
    out = mha_lanes._launch(stub, qkv, kmask, 2, hd ** -0.5, False, 0)
    dq, dm = mha_lanes._launch_backward(stub, qkv, kmask, torch.zeros(1, L, 2 * hd), 2,
                                        hd ** -0.5, True, 0)
    assert out.shape == (1, L, 2 * hd) and dq.shape == qkv.shape and dm.shape == (L,)
    assert stub.calls == [(fwd, len(_lib.SIGNATURES[fwd])), (bwd, len(_lib.SIGNATURES[bwd]))]
    assert (mha_lanes.launches, mha_lanes.launches_bwd) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("want_mask", [False, True])
def test_head_backward_takes_its_scratch_only_for_d_kmask(want_mask):
    """The one-block-a-head backward gets no row statistics: without d kmask
    null slab, counter and d kmask pointers; with it a [B * heads, L] slab
    and the device's one counter, the same tensor on every call, zeroed."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    stub = StubLib()
    qkv = torch.zeros(3, 65, 3 * 4 * 16)
    for _ in range(2):
        mha_lanes._call_backward(stub, mha_lanes.BWD_F32_HEAD, qkv, torch.zeros(65),
                                 torch.zeros(3, 65, 64), 4, 0.25, want_mask, 0)
    counter = mha_lanes.head_counter("cpu")
    assert counter.dtype == torch.int32 and counter.shape == (1,) and int(counter) == 0
    for args in stub.args:
        slab, count, dkmask = args[4:7]
        assert (slab != 0, count != 0, dkmask != 0) == (want_mask,) * 3
        assert count in (0, counter.data_ptr())
        assert args[7:12] == (3, 65, 64, 4, 0.25)


def test_f32_route_needs_the_length():
    """An f32 qkv is routed by its length too: asking without one raises
    rather than guessing a body."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    with pytest.raises(ValueError, match="length"):
        mha_lanes.kernel_entry(16, False, torch.float32)
    with pytest.raises(ValueError, match="length"):
        mha_lanes.backward_entry(16, torch.float32)
