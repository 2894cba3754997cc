"""K1's backward on the CPU: the port's plain backward against the JAX
package's, the model of the backward kernel's arithmetic against the plain
backward, and which C entry point the wrapper calls.

The JAX side is ``jax.vjp`` of ``oryon_tpu/ops/pallas/mha_lanes.py::
fused_mha_lanes_qkv`` with its Pallas forward in interpret mode (L a multiple
of 128, as that kernel asserts), or its ``_bwd`` itself at a ragged L (the
backward never reads the forward's output).  Tolerances: f32 within 1e-5
(the same plain attention differentiated in two packages); bf16 within 2e-2
of the largest |reference| value with cosine >= 0.9999 (both round S, P, dP
and dS * scale to bf16, but sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import StubLib, k1_backward_model, pallas_interpret

H = 2


def _inputs(L, hd, seed=7):
    """qkv [2, L, 3C], kmask [L] with the last fifth of the keys padded at
    -1e9, dout [2, L, C], f32 numpy from a seed."""
    rs = np.random.RandomState(seed)
    qkv = rs.randn(2, L, 3 * H * hd).astype(np.float32)
    kmask = np.where(np.arange(L) < L - L // 5, 0.0, -1e9).astype(np.float32)
    g = rs.randn(2, L, H * hd).astype(np.float32)
    return qkv, kmask, g


def _close(got, ref, dtype, what):
    got = np.asarray(got, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=what)
        return
    top = np.abs(ref).max()
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)) if top > 0 else 1.0
    assert np.abs(got - ref).max() <= 2e-2 * top and cos >= 0.9999, (what, cos)


# every head dim and dtype at a ragged L; two through the whole custom_vjp
PLAIN_CASES = [(hd, dtype, 77) for hd in (16, 32, 64) for dtype in ("f32", "bf16")] + [
    (32, "f32", 128), (64, "bf16", 128)]


@pytest.mark.parametrize("hd,dtype,L", PLAIN_CASES)
def test_plain_backward_matches_jax(hd, dtype, L):
    """The port's backward on the CPU (``MhaLanesFunction`` under autograd,
    which runs ``reference_mha_backward``) against the JAX package's: d qkv
    and d kmask, masked keys, ragged and aligned L."""
    from oryon_tpu.ops.pallas import mha_lanes as jax_k1
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    qkv, kmask, g = _inputs(L, hd)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x, m, gj = jnp.asarray(qkv, jdt), jnp.asarray(kmask), jnp.asarray(g, jdt)
    if L % 128 == 0:
        with pallas_interpret():
            _, vjp = jax.vjp(lambda a, b: jax_k1.fused_mha_lanes_qkv(a, b, H, hd ** -0.5), x, m)
            dq_ref, dm_ref = vjp(gj)
    else:
        dq_ref, dm_ref = jax_k1._bwd(H, hd ** -0.5, True, False, (x, m), gj)
    xt = torch.from_numpy(qkv).to(tdt).requires_grad_()
    mt = torch.from_numpy(kmask).requires_grad_()
    dq, dm = torch.autograd.grad(fused_mha_lanes_qkv(xt, mt, H, hd ** -0.5), (xt, mt),
                                 torch.from_numpy(g).to(tdt))
    assert dq.dtype == tdt and dm.dtype == torch.float32
    _close(dq.float().numpy(), np.asarray(dq_ref, np.float32), dtype, "d qkv")
    _close(dm.numpy(), np.asarray(dm_ref, np.float32), dtype, "d kmask")


@pytest.mark.parametrize("L", [130, 64, 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_model_matches_plain_backward(dtype, L):
    """The model of the backward kernel's arithmetic (online row statistics
    over key tiles of 64, D = rowsum(P * dP), the reference's rounding points)
    against autograd through ``reference_mha``, at more than one key tile,
    exactly one and a single key."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import reference_mha_backward

    qkv, kmask, g = _inputs(L, 32, seed=8)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, m, gt = torch.from_numpy(qkv).to(tdt), torch.from_numpy(kmask), torch.from_numpy(g).to(tdt)
    got, got_m = k1_backward_model(x, m, gt, H, 32 ** -0.5)
    ref, ref_m = reference_mha_backward(x, m, gt, H, 32 ** -0.5, True)
    assert got.dtype == tdt
    _close(got.float().numpy(), ref.float().numpy(), dtype, "d qkv")
    _close(got_m.numpy(), ref_m.numpy(), dtype, "d kmask")


@pytest.mark.parametrize("L", [577, 130, 64, 1])
def test_log2_model_matches_plain_backward(L):
    """The model of the head-dim-64 kernels' arithmetic (logits in log2
    units, exp2) against autograd through ``reference_mha`` at bf16: the
    tower's L, several tiles, one tile and a single key."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import reference_mha_backward

    qkv, kmask, g = _inputs(L, 64, seed=10)
    x, m, gt = (torch.from_numpy(a) for a in (qkv, kmask, g))
    x, gt = x.bfloat16(), gt.bfloat16()
    got, got_m = k1_backward_model(x, m, gt, H, 0.125, log2=True)
    ref, ref_m = reference_mha_backward(x, m, gt, H, 0.125, True)
    _close(got.float().numpy(), ref.float().numpy(), "bf16", "d qkv")
    _close(got_m.numpy(), ref_m.numpy(), "bf16", "d kmask")


@pytest.mark.parametrize("want_mask", [False, True])
@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "oryon_mha_lanes_bwd_bf16"),
                                         (torch.float32, "oryon_mha_lanes_bwd_f32")])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_backward_wrapper_chooses_the_entry(hd, dtype, entry, want_mask):
    """Every head dim of either dtype goes to its dtype's entry (head dim 64
    in bf16 to the wgmma entry, with both phases; f32 at head dims 16 and 32,
    L = 8, to the one-block-a-head entry) with the arguments its signature
    lists; d kmask is allocated only when asked for; one launch is counted on
    ``launches_bwd`` (K1's own count unchanged)."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    if hd == 64 and dtype == torch.bfloat16:
        entry = "oryon_mha_lanes_bwd_wgmma_bf16"
    if hd <= 32 and dtype == torch.float32:
        entry = mha_lanes.BWD_F32_HEAD
    stub = StubLib()
    qkv = torch.zeros(1, 8, 3 * 2 * hd, dtype=dtype)
    before = (mha_lanes.launches, mha_lanes.launches_bwd)
    dqkv, dm = mha_lanes._launch_backward(stub, qkv, torch.zeros(8),
                                          torch.zeros(1, 8, 2 * hd, dtype=dtype), 2,
                                          hd ** -0.5, want_mask, 0)
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert (dm is not None) == want_mask and (dm is None or dm.shape == (8,))
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert mha_lanes.backward_entry(hd, dtype, 8) == entry
    assert (mha_lanes.launches, mha_lanes.launches_bwd) == (before[0], before[1] + 1)
    if entry == mha_lanes.BWD_WGMMA:
        assert stub.args[0][-2] == mha_lanes.BWD_DQ | mha_lanes.BWD_DKV


@pytest.mark.parametrize("entry,phases", [
    ("oryon_mha_lanes_bwd_bf16", None),
    ("oryon_mha_lanes_bwd_wgmma_bf16", 1), ("oryon_mha_lanes_bwd_wgmma_bf16", 2),
    ("oryon_mha_lanes_bwd_wgmma_bf16", 3)])
def test_backward_entry_by_name_passes_its_phases(entry, phases):
    """The timed-only path (``run_backward_entry``'s call): any named entry
    with its signature's arguments, the phases to the head-dim-64 entry only,
    and no launch counted."""
    from oryon_tpu_torch.ops.cuda import _lib, mha_lanes

    stub = StubLib()
    qkv = torch.zeros(1, 8, 3 * 2 * 64, dtype=torch.bfloat16)
    before = mha_lanes.launches_bwd
    kw = {} if phases is None else {"phases": phases}
    dqkv, dm = mha_lanes._call_backward(stub, entry, qkv, torch.zeros(8),
                                        torch.zeros(1, 8, 2 * 64, dtype=torch.bfloat16), 2,
                                        0.125, True, 0, **kw)
    assert dqkv.shape == qkv.shape and dm.shape == (8,)
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    if phases is not None:
        assert stub.args[0][-2] == phases
    assert mha_lanes.launches_bwd == before


def test_backward_refuses_what_has_no_kernel(monkeypatch):
    """Other head dims and dtypes have no backward entry; a tensor on neither
    the CPU nor a CUDA device raises, and neither path reaches for the plain
    version."""
    from oryon_tpu_torch.ops.cuda import mha_lanes

    def plain(*a, **kw):
        raise AssertionError("reached the plain backward")
    for bad in (8, 48, 96, 256):
        with pytest.raises(ValueError, match="head dim"):
            mha_lanes.backward_entry(bad, torch.bfloat16)
    with pytest.raises(TypeError):
        mha_lanes.backward_entry(64, torch.float16)
    monkeypatch.setattr(mha_lanes, "reference_mha_backward", plain)
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        mha_lanes._backward(qkv, torch.zeros(8, device="meta"),
                            torch.zeros(1, 8, 2 * 64, device="meta", dtype=torch.bfloat16),
                            2, 0.125, False)


def test_qk_int8_gradient_is_straight_through():
    """With ``qk_int8`` the backward is the same function (the JAX ``_bwd``
    ignores the quantisation): bitwise the gradient without it, d kmask too."""
    from oryon_tpu_torch.ops.cuda.mha_lanes import fused_mha_lanes_qkv

    qkv, kmask, g = _inputs(96, 64, seed=9)
    x = torch.from_numpy(qkv).bfloat16().requires_grad_()
    m = torch.from_numpy(kmask).requires_grad_()
    grads = [torch.autograd.grad(fused_mha_lanes_qkv(x, m, H, 0.125, qk_int8=i8), (x, m),
                                 torch.from_numpy(g).bfloat16()) for i8 in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
