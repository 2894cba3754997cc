"""K2's fp32 mode on the CPU: the split of f32 values into TF32 hi and lo
parts, the arithmetic of the split-TF32 tensor-core kernel
(``csrc/match_tf32.cuh``) and the wrapper's route for that mode.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here its arithmetic is a pure-PyTorch model
(``_torch_helpers.tiled_argmin_model(precision="fp32")``: the kept targets
compacted in order, both operands split, the three TF32 products of each k8
slice in the kernel's order into one f32 sum, tiles of 128 targets with the
running maximum, the target splits and their merge), held against the JAX
package's ``masked_argmin_pallas`` in interpret mode and its
``_streaming_argmin(precision="fp32")`` on the same numpy inputs.  The gates
are the mode's own: minima within 1e-5, and an argmin may differ only where
the two f64 distances lie within 1e-6 of each other (the split keeps about
22 bits of each input, so sums move by about 1e-7).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (StubLib, compact_model, pallas_interpret, tf32_split_model,
                            tiled_argmin_model)

D = 32


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _case(name):
    """(src [S, D], tgt [N, D], bad [N]) of one named case, from a seed."""
    rs = np.random.RandomState(31)
    S, N = {"ragged": (200, 700), "random": (256, 512), "sparse": (130, 1500)}.get(name,
                                                                                 (150, 400))
    src, tgt = _unit(rs.randn(S, D)), _unit(rs.randn(N, D))
    bad = rs.rand(N) < (0.95 if name == "sparse" else 0.4)
    if name == "all-excluded":
        bad[:] = True
    elif name == "one-kept":
        bad[:] = True
        bad[211] = False
    elif name == "none-excluded":
        bad[:] = False
    elif name == "duplicates":
        # the best target of rows 0-39 three times: the lowest index wins
        tgt[200:240] = tgt[60:100]
        tgt[N - 40:] = tgt[60:100]
        bad[60:100] = bad[200:240] = bad[N - 40:] = False
        src[:40] = tgt[60:100]
    return src, tgt, bad


def _hold(got_d, got_a, ref_d, ref_a, src, tgt, bad):
    """Minima within 1e-5; an argmin differs only at an f64 near-tie (1e-6)
    and never names an excluded target."""
    got_d, got_a = np.asarray(got_d), np.asarray(got_a)
    ref_d, ref_a = np.asarray(ref_d), np.asarray(ref_a)
    np.testing.assert_allclose(got_d, ref_d, atol=1e-5, rtol=0)
    dist = 0.5 * (1.0 - src.astype(np.float64) @ tgt.astype(np.float64).T)
    for s in np.nonzero(got_a != ref_a)[0]:
        assert not bad[got_a[s]]
        assert abs(dist[s, got_a[s]] - dist[s, ref_a[s]]) <= 1e-6, (s, got_a[s], ref_a[s])


MODEL_CASES = ["random", "ragged", "sparse", "one-kept", "none-excluded", "duplicates"]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_fp32_tile_model_matches_pallas_kernel(case):
    """The kernel's arithmetic against the TPU kernel in interpret mode.  S
    and N of the ragged and sparse cases lie off the tiles of both kernels:
    the Pallas call gets the sources padded with zero rows to its 128-row
    tiles (dropped after) and the targets padded with excluded ones."""
    import oryon_tpu.ops.pallas.match_kernel as jmk

    src, tgt, bad = _case(case)
    S, N = src.shape[0], tgt.shape[0]
    Sp, Np = -(-S // 128) * 128, -(-N // 128) * 128
    src_p = np.zeros((Sp, D), np.float32)
    src_p[:S] = src
    tgt_p = np.zeros((Np, D), np.float32)
    tgt_p[:N] = tgt
    tgt_p[N:, 0] = 1.0
    bad_p = np.ones(Np, bool)
    bad_p[:N] = bad
    got_d, got_a = tiled_argmin_model(src, tgt, bad, precision="fp32")
    with pallas_interpret():
        ref_d, ref_a = jmk.masked_argmin_pallas(jnp.asarray(src_p), jnp.asarray(tgt_p),
                                                jnp.asarray(bad_p), src_tile=128, tgt_chunk=128)
    _hold(got_d.numpy(), got_a.numpy(), np.asarray(ref_d)[:S], np.asarray(ref_a)[:S],
          src, tgt, bad)
    if case == "one-kept":
        assert (got_a == 211).all()
    if case == "duplicates":
        assert torch.equal(got_a[:40], torch.arange(60, 100, dtype=torch.int32))


@pytest.mark.parametrize("case", MODEL_CASES + ["all-excluded"])
def test_fp32_tile_model_matches_jax_streaming_argmin(case):
    """The same against the JAX package's ``_streaming_argmin`` in its fp32
    mode (one chunk over all targets, so any N); a pair with every target
    excluded gives (+inf, 0) in both."""
    from oryon_tpu.ops.matching import _streaming_argmin

    src, tgt, bad = _case(case)
    got_d, got_a = tiled_argmin_model(src, tgt, bad, precision="fp32")
    ref_d, ref_a = _streaming_argmin(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(bad),
                                     tgt.shape[0], "fp32")
    if case == "all-excluded":
        assert np.isinf(np.asarray(ref_d)).all() and torch.isinf(got_d).all()
        assert (got_d > 0).all() and (got_a == 0).all() and (np.asarray(ref_a) == 0).all()
    else:
        _hold(got_d.numpy(), got_a.numpy(), ref_d, ref_a, src, tgt, bad)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_fp32_tile_model_matches_plain_version(case):
    """The same against the port's plain version of the mode (chunked f32
    matmuls)."""
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin_plain

    src, tgt, bad = _case(case)
    got_d, got_a = tiled_argmin_model(src, tgt, bad, precision="fp32")
    ref_d, ref_a = masked_argmin_plain(torch.from_numpy(src)[None], torch.from_numpy(tgt)[None],
                                       torch.from_numpy(bad)[None], "fp32")
    _hold(got_d.numpy(), got_a.numpy(), ref_d[0].numpy(), ref_a[0].numpy(), src, tgt, bad)


@pytest.mark.parametrize("splits", [2, 5])
def test_fp32_target_splits_do_not_change_the_result(splits):
    """Ranges of tiles that start anew and merge in order (strict ``>``)
    give the unsplit result bitwise under the three-product sums too."""
    src, tgt, bad = _case("ragged")
    whole_d, whole_a = tiled_argmin_model(src, tgt, bad, precision="fp32")
    got_d, got_a = tiled_argmin_model(src, tgt, bad, splits=splits, precision="fp32")
    assert torch.equal(got_a, whole_a) and torch.equal(got_d, whole_d)


def _tf32_reference(x):
    """x rounded to 10 bits of mantissa, to nearest with ties away from zero,
    by f64 arithmetic on the value (normal f32 inputs)."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)                       # |x| = m 2^e, m in [0.5, 1)
    unit = np.ldexp(1.0, e - 11)             # one unit of a 10-bit mantissa
    return (np.sign(x) * np.floor(np.abs(x) / unit + 0.5) * unit).astype(np.float32)


def _values(kind):
    rs = np.random.RandomState(5)
    if kind == "unit-rows":
        return _unit(rs.randn(64, D)).reshape(-1)
    if kind == "wide":
        return (rs.randn(4096) * np.exp2(rs.randint(-60, 60, 4096))).astype(np.float32)
    # ties and their neighbours: low 13 bits 0x1000 (exactly half a unit),
    # 0x0fff and 0x1001, both signs
    high = rs.randint(0x0C800000, 0x4C800000, 1024).astype(np.uint32) & np.uint32(0xFFFFE000)
    low = np.array([0x1000, 0x0FFF, 0x1001], np.uint32)
    bits = (high[:, None] | low[None, :]).reshape(-1)
    x = bits.view(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize("kind", ["unit-rows", "wide", "ties"])
def test_split_tf32_plain(kind):
    """``split_tf32_plain``: hi and lo have their 13 low mantissa bits zero,
    hi agrees bitwise with an f64 rounding to nearest with ties away from
    zero (and with the numpy model of the kernel's bit operations), and
    hi + lo equals x within 2^-22 |x|."""
    from oryon_tpu_torch.ops.cuda.match_kernel import split_tf32_plain

    x = _values(kind)
    hi, lo = (t.numpy() for t in split_tf32_plain(torch.from_numpy(x)))
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(hi.view(np.uint32), _tf32_reference(x).view(np.uint32))
    m_hi, m_lo = tf32_split_model(x)
    np.testing.assert_array_equal(hi.view(np.uint32), m_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), m_lo.view(np.uint32))
    x64 = x.astype(np.float64)
    assert (np.abs(x64 - hi.astype(np.float64) - lo.astype(np.float64))
            <= np.ldexp(np.abs(x64), -22)).all()
    if kind == "ties":
        # exactly half a unit rounds the magnitude up, on both signs
        tie = (x.view(np.uint32) & np.uint32(0x1FFF)) == 0x1000
        assert (np.abs(hi[tie]) > np.abs(x[tie])).all()


def test_split_prepass_model_matches_plain_versions():
    """The fp32 pre-pass: the kept rows in order, each split, beside the
    index map and count of ``torch.nonzero`` (what the card checks bitwise
    against ``split_tf32_plain``)."""
    from oryon_tpu_torch.ops.cuda.match_kernel import compact_targets_plain, split_tf32_plain

    _, tgt, bad = _case("ragged")
    kept = torch.nonzero(~torch.from_numpy(bad)).flatten()
    _, idx_map, count = compact_model(tgt, bad)
    assert count == kept.numel() and np.array_equal(idx_map, kept.numpy())
    hi, lo = split_tf32_plain(torch.from_numpy(tgt)[kept])
    m_hi, m_lo = tf32_split_model(tgt[idx_map])
    assert torch.equal(hi, torch.from_numpy(m_hi)) and torch.equal(lo, torch.from_numpy(m_lo))
    _, pmap, pcount = compact_targets_plain(torch.from_numpy(tgt)[None], torch.from_numpy(bad)[None])
    assert int(pcount[0]) == count and np.array_equal(pmap[0, :count].numpy(), idx_map)


class _FailingLib(StubLib):
    """A kernel library whose entries report cudaErrorInvalidValue."""

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, len(args)))
            return 1
        return entry


def test_fp32_route_raises_when_the_library_cannot_be_loaded(monkeypatch):
    """A failed build or load of the kernel library raises out of the CUDA
    route; the plain version is never taken in its stead."""
    from oryon_tpu_torch.ops.cuda import _lib, match_kernel

    def no_library():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")

    def no_plain(*a, **kw):
        raise AssertionError("the CUDA route fell back to the plain version")
    monkeypatch.setattr(_lib, "library", no_library)
    monkeypatch.setattr(match_kernel, "masked_argmin_plain", no_plain)
    src, tgt, bad = torch.zeros(2, 8, D), torch.zeros(2, 12, D), torch.zeros(2, 12, dtype=torch.bool)
    before = match_kernel.launches_fp32
    with pytest.raises(RuntimeError, match="nvcc not found"):
        match_kernel._on_card(src, tgt, bad, "fp32")
    assert match_kernel.launches_fp32 == before


def test_fp32_route_raises_when_the_kernel_fails():
    """An error code from the split-TF32 entry raises and counts no launch;
    no other entry (the CUDA-core kernel) is tried."""
    from oryon_tpu_torch.ops.cuda import match_kernel

    lib = _FailingLib()
    src, tgt, bad = torch.zeros(2, 8, D), torch.zeros(2, 12, D), torch.zeros(2, 12, dtype=torch.bool)
    before = match_kernel.launches_fp32
    with pytest.raises(RuntimeError, match=r"masked_argmin\(fp32\) failed"):
        match_kernel._launch(lib, src, tgt, bad, "fp32", 0)
    assert [name for name, _ in lib.calls] == ["oryon_masked_argmin_wgmma_tf32x3"]
    assert match_kernel.launches_fp32 == before
