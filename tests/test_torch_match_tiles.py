"""The arithmetic of K2's tensor-core kernel (``csrc/match_wgmma.cuh``, the
bf16 mode of ``masked_argmin``) and the wrapper's choice of kernel by mode,
on the CPU.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  What can be held here is its arithmetic: a pure-PyTorch
model (``_torch_helpers.tiled_argmin_model``: order-preserving compaction
with an index map and a count, target tiles of 128, the maximum of the sum
tracked per lane with a strict ``>``, the first column inside a winning
tile, the four lanes merged at the end, ranges of tiles that start anew and
are merged in order, the distance formed once a row)
against the port's plain version and the JAX package's functions on the same
numpy inputs.  Tolerances: argmins identical, because every case's inputs
are checked to hold no near-tie (the two best distances of a row at least
1e-6 apart, or exactly equal for the duplicated targets) so the order of an
f32 sum cannot decide; minima within 1e-5, the f32 gate of K2 (in fact the
sums of 32 exact products differ in the last bit or two, about 1e-7).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import StubLib, compact_model, pallas_interpret, tiled_argmin_model

D = 32


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _blob(n_side: int, keep_frac: float):
    """A square blob in an n_side x n_side map: False (kept) inside."""
    side = max(1, int(round(n_side * keep_frac ** 0.5)))
    bad = np.ones((n_side, n_side), bool)
    bad[3:3 + side, 5:5 + side] = False
    return bad.reshape(-1)


def _case(name):
    """(src [S, D], tgt [N, D], bad [N]) of one named case, from a seed."""
    rs = np.random.RandomState(21)
    S, N = {"ragged": (200, 700), "aligned": (256, 1024)}.get(name, (130, 300))
    src, tgt = _unit(rs.randn(S, D)), _unit(rs.randn(N, D))
    bad = rs.rand(N) < 0.4
    if name == "all-excluded":
        bad[:] = True
    elif name == "one-kept":
        bad[:] = True
        bad[137] = False
    elif name == "none-excluded":
        bad[:] = False
    elif name == "duplicates":
        # the best target of every row of the first half exists three times:
        # the lowest index must win, bitwise
        tgt[200:240] = tgt[60:100]
        tgt[260:300] = tgt[60:100]
        bad[60:100] = bad[200:240] = bad[260:300] = False
        src[:40] = tgt[60:100]
    elif name == "blob-95":
        N = 32 * 32
        tgt, bad = _unit(rs.randn(N, D)), _blob(32, 0.05)
    return src, tgt, bad


CASES = ["ragged", "aligned", "all-excluded", "one-kept", "none-excluded", "duplicates",
         "blob-95"]


def _no_near_tie(src, tgt, bad):
    """True if no row's two best kept distances (bf16-rounded inputs, f64
    sums) lie within 1e-6 of each other without being equal."""
    s = torch.from_numpy(src).bfloat16().double()
    t = torch.from_numpy(tgt).bfloat16().double()[~torch.from_numpy(bad)]
    if t.shape[0] < 2:
        return True
    two = torch.topk(0.5 * (1.0 - s @ t.T), 2, dim=1, largest=False).values
    gap = two[:, 1] - two[:, 0]
    return bool(((gap == 0) | (gap > 1e-6)).all())


@pytest.mark.parametrize("case", CASES)
def test_k2_tile_model_matches_plain_version(case):
    """The kernel's arithmetic against ``masked_argmin_plain`` in bf16 mode:
    argmins identical (no near-ties in the inputs), minima within 1e-5;
    every target excluded gives (+inf, 0); duplicated targets give the
    lowest index."""
    from oryon_tpu_torch.ops.cuda.match_kernel import masked_argmin_plain

    src, tgt, bad = _case(case)
    assert _no_near_tie(src, tgt, bad)
    got_d, got_a = tiled_argmin_model(src, tgt, bad)
    ref_d, ref_a = masked_argmin_plain(torch.from_numpy(src)[None], torch.from_numpy(tgt)[None],
                                       torch.from_numpy(bad)[None], "bf16")
    assert got_a.dtype == torch.int32
    assert torch.equal(got_a, ref_a[0])
    if case == "all-excluded":
        assert torch.isinf(got_d).all() and (got_d > 0).all() and (got_a == 0).all()
        assert torch.equal(got_d, ref_d[0])
    else:
        assert float((got_d - ref_d[0]).abs().max()) < 1e-5
    if case == "one-kept":
        assert (got_a == 137).all()
    if case == "duplicates":
        assert torch.equal(got_a[:40], torch.arange(60, 100, dtype=torch.int32))


@pytest.mark.parametrize("case", CASES)
def test_k2_tile_model_matches_jax_streaming_argmin(case):
    """The same against the JAX package's default path ``_streaming_argmin``
    in its bf16 mode (one chunk over all targets, so any N)."""
    from oryon_tpu.ops.matching import _streaming_argmin

    src, tgt, bad = _case(case)
    got_d, got_a = tiled_argmin_model(src, tgt, bad)
    ref_d, ref_a = _streaming_argmin(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(bad),
                                     tgt.shape[0], "bf16")
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    if case == "all-excluded":
        assert np.isinf(np.asarray(ref_d)).all() and torch.isinf(got_d).all()
    else:
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5)


@pytest.mark.parametrize("case", ["aligned", "duplicates-aligned"])
def test_k2_tile_model_matches_pallas_kernel(case):
    """The same against the TPU kernel in interpret mode, on the bf16-rounded
    inputs (it multiplies what it is given; S and N multiples of its tiles,
    at least one target kept, as that kernel needs)."""
    import oryon_tpu.ops.pallas.match_kernel as jmk

    src, tgt, bad = _case("aligned")
    if case == "duplicates-aligned":
        tgt[512:552] = tgt[60:100]
        bad[60:100] = bad[512:552] = False
        src[:40] = tgt[60:100]
    src16 = torch.from_numpy(src).bfloat16().float().numpy()
    tgt16 = torch.from_numpy(tgt).bfloat16().float().numpy()
    got_d, got_a = tiled_argmin_model(src, tgt, bad)
    with pallas_interpret():
        ref_d, ref_a = jmk.masked_argmin_pallas(jnp.asarray(src16), jnp.asarray(tgt16),
                                                jnp.asarray(bad), src_tile=128, tgt_chunk=256)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5)
    if case == "duplicates-aligned":
        np.testing.assert_array_equal(got_a.numpy()[:40], np.arange(60, 100))


@pytest.mark.parametrize("case", CASES)
def test_k2_compaction_matches_nonzero(case):
    """The pre-pass: the model's and the plain version's compacted rows,
    index map and count against ``torch.nonzero`` of the kept flags, exactly."""
    from oryon_tpu_torch.ops.cuda.match_kernel import compact_targets_plain

    _, tgt, bad = _case(case)
    kept = torch.nonzero(~torch.from_numpy(bad)).flatten()
    t16, idx_map, count = compact_model(tgt, bad)
    assert count == kept.numel()
    assert np.array_equal(idx_map, kept.numpy().astype(np.int32))
    assert torch.equal(t16, torch.from_numpy(tgt)[kept].bfloat16())
    p16, pmap, pcount = compact_targets_plain(torch.from_numpy(tgt)[None],
                                              torch.from_numpy(bad)[None])
    assert p16.dtype == torch.bfloat16 and pmap.dtype == pcount.dtype == torch.int32
    assert int(pcount[0]) == count
    assert torch.equal(p16[0, :count], t16) and np.array_equal(pmap[0, :count].numpy(), idx_map)
    assert not p16[0, count:].any() and not pmap[0, count:].any()


@pytest.mark.parametrize("tile", [64, 128, 256])
def test_k2_tile_size_does_not_change_the_result(tile):
    """The width of a target tile only moves where the strict ``>`` between
    tiles falls: same argmins, bitwise the same minima."""
    src, tgt, bad = _case("ragged")
    whole_d, whole_a = tiled_argmin_model(src, tgt, bad, tile=1024)
    got_d, got_a = tiled_argmin_model(src, tgt, bad, tile=tile)
    assert torch.equal(got_a, whole_a) and torch.equal(got_d, whole_d)


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("case", ["ragged", "duplicates", "one-kept"])
def test_k2_target_splits_do_not_change_the_result(case, splits):
    """Cutting a pair's tiles into ranges that start anew and merging them in
    order (strict ``>``) gives the unsplit result bitwise, empty ranges
    included (seven ranges over the one tile of ``one-kept``)."""
    src, tgt, bad = _case(case)
    whole_d, whole_a = tiled_argmin_model(src, tgt, bad)
    got_d, got_a = tiled_argmin_model(src, tgt, bad, splits=splits)
    assert torch.equal(got_a, whole_a) and torch.equal(got_d, whole_d)


def test_k2_wrapper_splits_the_targets_by_shape_and_card():
    """``target_splits``: the serving batch on a card of 132 SMs is cut in
    two; small grids are cut up to twice the resident blocks but never into
    ranges under eight tiles; a grid that fills the card is not cut."""
    from oryon_tpu_torch.ops.cuda.match_kernel import target_splits

    assert target_splits(8, 5120, 36864, 132) == 2
    assert target_splits(64, 5120, 36864, 132) == 1
    assert target_splits(1, 5120, 36864, 132) == 14
    assert target_splits(1, 128, 36864, 132) == 36        # 288 tiles / 8
    assert target_splits(3, 700, 1000, 132) == 1          # 8 tiles in all
    for P, S, N in [(1, 1, 1), (2, 64, 128), (8, 5000, 36001), (4, 333, 100000)]:
        n = target_splits(P, S, N, 132)
        assert n >= 1 and (n == 1 or -(-N // 128) // n >= 8)


@pytest.mark.parametrize("precision,entry", [("bf16", "oryon_masked_argmin_wgmma_bf16"),
                                             ("fp32", "oryon_masked_argmin_wgmma_tf32x3")])
def test_k2_wrapper_chooses_the_kernel_by_mode(precision, entry):
    """bf16 goes to the bf16 tensor-core kernel, fp32 to the split-TF32
    tensor-core kernel (one call runs the pre-pass and the main kernel
    either way); one launch is counted on the mode's own count."""
    from oryon_tpu_torch.ops.cuda import _lib, match_kernel

    stub = StubLib()
    src, tgt = torch.zeros(2, 8, D), torch.zeros(2, 12, D)
    before = (match_kernel.launches, match_kernel.launches_fp32)
    out_min, out_arg = match_kernel._launch(stub, src, tgt, torch.zeros(2, 12, dtype=torch.bool),
                                            precision, 0)
    assert out_min.shape == out_arg.shape == (2, 8)
    assert out_min.dtype == torch.float32 and out_arg.dtype == torch.int32
    assert stub.calls == [(entry, len(_lib.SIGNATURES[entry]))]
    assert match_kernel.kernel_entry(precision) == entry
    bf16_more, fp32_more = (precision == "bf16"), (precision == "fp32")
    assert (match_kernel.launches, match_kernel.launches_fp32) == (before[0] + bf16_more,
                                                                 before[1] + fp32_more)


def test_k2_no_kernel_for_other_precisions():
    from oryon_tpu_torch.ops.cuda import match_kernel

    with pytest.raises(ValueError, match="precision"):
        match_kernel.kernel_entry("fp16")
    with pytest.raises(ValueError, match="precision"):
        match_kernel.kernel_entry("tf32")
