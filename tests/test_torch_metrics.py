"""The scoring metrics and the remaining geometry functions of the port
against their JAX counterparts on seeded inputs.  f32 on both sides: 1e-5
relative (plus 1e-6 absolute for values near 0) unless a test says otherwise;
poses by the geodesic bound of tests/test_torch_geometry.py (1e-3 rad, 1e-4 m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import rotation_angle

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose(rs, t_scale=0.2, angle=None):
    Q, _ = np.linalg.qr(rs.randn(3, 3))
    Q *= np.sign(np.linalg.det(Q))
    if angle is not None:     # a rotation by ``angle`` about a random axis
        a = rs.randn(3)
        a /= np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        Q = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = Q, rs.randn(3) * t_scale
    return T


def test_rotation_translation_errors_match_jax():
    """Angles of 0.5 to 170 degrees (away from 0, where the arccos of an f32
    trace resolves 0.02 degree in either package), scaled rotations included
    (the determinant normalisation): 1e-5 relative plus 2e-3 degree on the
    angle, since the arccos turns the last bit of an f32 trace into 8e-4
    degree at 0.5 degree."""
    from oryon_tpu.eval.metrics import rotation_translation_errors as ref_fn
    from oryon_tpu_torch.eval.metrics import rotation_translation_errors

    rs = np.random.RandomState(0)
    angles = np.deg2rad([0.5, 3.0, 20.0, 90.0, 170.0, 45.0])
    P1 = np.stack([_pose(rs) for _ in angles])
    P2 = P1.copy()
    for i, ang in enumerate(angles):
        P2[i] = _pose(rs, angle=ang) @ P1[i]
    P2[5, :3, :3] *= 1.7
    ref_r, ref_t = ref_fn(jnp.array(P1), jnp.array(P2))
    got_r, got_t = rotation_translation_errors(_t(P1), _t(P2))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)
    np.testing.assert_allclose(got_r.numpy(), np.rad2deg(angles), rtol=2e-3)
    # f64 poses keep f64: a difference of 1e-5 rad is resolved
    small = _pose(rs, angle=1e-5).astype(np.float64)
    r64, _ = rotation_translation_errors(_t(small), torch.eye(4, dtype=torch.float64))
    assert r64.dtype == torch.float64
    np.testing.assert_allclose(np.deg2rad(r64.item()), 1e-5, rtol=1e-3)
    # a pose that is all NaN reads 180 degrees, as there
    bad = np.full((4, 4), np.nan, np.float32)
    assert rotation_translation_errors(_t(bad), _t(P1[0]))[0].item() == 180.0
    assert float(ref_fn(jnp.array(bad), jnp.array(P1[0]))[0]) == 180.0


@pytest.mark.parametrize("weights", ["none", "some", "all_invalid"])
@pytest.mark.parametrize("metric", ["compute_add", "compute_adds"])
def test_add_metrics_match_jax(metric, weights):
    """ADD and ADD-S on a batch of model clouds, unweighted, with 0/1 point
    weights, and with every weight 0 (both packages guard the division and
    give 0)."""
    from oryon_tpu.eval import metrics as jm
    from oryon_tpu_torch.eval import metrics as tm

    rs = np.random.RandomState(1)
    Bn, N = 3, 257
    pts = (rs.rand(Bn, N, 3).astype(np.float32) - 0.5) * 0.2
    pred = np.stack([_pose(rs) for _ in range(Bn)])
    gt = np.stack([_pose(rs, angle=0.05) @ p for p in pred])
    w = {"none": None, "some": (rs.rand(Bn, N) > 0.3).astype(np.float32),
         "all_invalid": np.zeros((Bn, N), np.float32)}[weights]
    ref = getattr(jm, metric)(jnp.array(pts), jnp.array(pred), jnp.array(gt),
                              None if w is None else jnp.array(w))
    got = getattr(tm, metric)(_t(pts), _t(pred), _t(gt), None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if weights == "all_invalid":
        assert (got == 0).all()


def test_compute_adds_chunks_do_not_change_the_result():
    """The nearest-neighbour minimum walked 64 sources at a time equals the
    one-matrix result exactly, also when the last chunk is ragged."""
    from oryon_tpu_torch.eval.metrics import compute_adds

    rs = np.random.RandomState(2)
    pts = _t((rs.rand(1000, 3).astype(np.float32) - 0.5) * 0.3)
    pred, gt = _t(_pose(rs)), _t(_pose(rs))
    whole = compute_adds(pts, pred, gt, chunk=4096)
    assert torch.equal(compute_adds(pts, pred, gt, chunk=64), whole)
    assert torch.equal(compute_adds(pts, pred, gt, chunk=333), whole)
    # ADD-S of a pose with itself: the matmul expansion of |p - g|^2 cancels
    # to about 1e-10 at these norms, its root is 1e-5
    assert compute_adds(pts, pred, pred).item() < 1e-4


@pytest.mark.parametrize("norm", [False, True])
def test_entropy_matches_jax(norm):
    from oryon_tpu.eval.metrics import entropy as ref_fn
    from oryon_tpu_torch.eval.metrics import entropy

    rs = np.random.RandomState(3)
    p = rs.rand(4, 7, 5).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[0, :, 0] = 0.0
    p[0, 2, 0] = 1.0                     # a one-hot column: entropy 0
    ref = ref_fn(jnp.array(p), axis=1, norm=norm)
    got = entropy(_t(p), axis=1, norm=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert abs(got[0, 0].item()) < 1e-6


def test_pixel_match_loss_matches_jax():
    """Host-side Hungarian distance, f64 in both: equal to 1e-12; an empty
    set scores 0."""
    from oryon_tpu.eval.metrics import pixel_match_loss as ref_fn
    from oryon_tpu_torch.eval.metrics import pixel_match_loss

    rs = np.random.RandomState(4)
    gt = rs.randint(0, 192, (3, 20, 4))
    pred = rs.randint(0, 192, (3, 14, 4))
    np.testing.assert_allclose(pixel_match_loss(gt, _t(pred)), ref_fn(gt, pred), rtol=1e-12)
    np.testing.assert_allclose(pixel_match_loss(gt, gt), 0.0, atol=1e-12)
    empty = np.zeros((3, 0, 4))
    np.testing.assert_array_equal(pixel_match_loss(gt, empty), np.zeros(3))
    np.testing.assert_array_equal(ref_fn(gt, empty), np.zeros(3))


def test_lift_pcd_matches_jax():
    """A whole depth image, zero-depth pixels included, against the JAX
    function and against ``lift_pcd_at`` at every pixel."""
    from oryon_tpu.geometry.pcd import lift_pcd as ref_fn
    from oryon_tpu_torch.geometry.pcd import lift_pcd, lift_pcd_at

    rs = np.random.RandomState(5)
    H, W = 24, 32
    depth = (rs.rand(H, W) * 1000).astype(np.float32)
    depth[3, 4] = 0.0
    K = np.array([60.0, 0, 15.5, 0, 58.0, 11.5, 0, 0, 1], np.float32)
    got = lift_pcd(_t(depth), _t(K))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_fn(jnp.array(depth), jnp.array(K))),
                               **TOL)
    assert got.shape == (H * W, 3) and (got[3 * W + 4] == 0).all()
    ys, xs = np.mgrid[0:H, 0:W]
    yx = _t(np.stack([ys.ravel(), xs.ravel()], -1))[None]
    assert torch.equal(lift_pcd_at(_t(depth)[None], _t(K)[None], yx)[0], got)
    # a uint16 depth frame lifts like its float copy
    d16 = depth.astype(np.uint16)
    np.testing.assert_allclose(lift_pcd(_t(d16.astype(np.int32)), _t(K)).numpy(),
                               np.asarray(ref_fn(jnp.array(d16), jnp.array(K))), **TOL)


@pytest.mark.parametrize("kind", ["L2", "SquareL2", "inv_norm_cosine", "cosine"])
def test_pairwise_dist_matches_jax(kind):
    """Every kind on a batch, with a zero row (the epsilon guards); 1e-5
    absolute: the matmul expansion cancels to about 1e-6 at these norms."""
    from oryon_tpu.geometry import pcd as jp
    from oryon_tpu_torch.geometry import pcd as tp

    rs = np.random.RandomState(6)
    A = rs.randn(2, 9, 8).astype(np.float32)
    Bm = rs.randn(2, 11, 8).astype(np.float32)
    A[0, 0] = 0.0
    Bm[1, 3] = A[1, 2]
    ref = jp.pairwise_dist(jnp.array(A), jnp.array(Bm), kind)
    got = tp.pairwise_dist(_t(A), _t(Bm), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tp.pairwise_dist(_t(A), _t(Bm), "manhattan")
    if kind == "cosine":
        np.testing.assert_allclose(
            tp.cosine_matrix(_t(A), _t(Bm)).numpy(),
            np.asarray(jp.cosine_matrix(jnp.array(A), jnp.array(Bm))), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tp.inv_norm_cosine(_t(A), _t(Bm)).numpy(),
            np.asarray(jp.inv_norm_cosine(jnp.array(A), jnp.array(Bm))), rtol=1e-5, atol=1e-6)


def test_small_pcd_helpers_match_jax():
    """``transform_pcd_h``, ``diameter`` (extra channels ignored) and
    ``sample_select`` on the uniforms the JAX function draws from its key."""
    from oryon_tpu.geometry import pcd as jp
    from oryon_tpu_torch.geometry import pcd as tp

    rs = np.random.RandomState(7)
    pts = rs.randn(2, 40, 3).astype(np.float32)
    T = np.stack([_pose(rs), _pose(rs)])
    np.testing.assert_allclose(tp.transform_pcd_h(_t(pts), _t(T)).numpy(),
                               np.asarray(jp.transform_pcd_h(jnp.array(pts), jnp.array(T))),
                               **TOL)
    pts6 = np.concatenate([pts, 100 * rs.randn(2, 40, 3).astype(np.float32)], -1)
    np.testing.assert_allclose(tp.diameter(_t(pts6)).numpy(),
                               np.asarray(jp.diameter(jnp.array(pts6))), **TOL)
    assert tp.diameter(_t(np.array([[0.0, 0, 0], [1, 2, 0.5], [-1, 0, 0]]))).item() == 2.0
    key = jax.random.PRNGKey(3)
    for n_avail in (1, 37, 5000):
        ref = jp.sample_select(key, jnp.array(n_avail), 256)
        u = np.asarray(jax.random.uniform(key, (256,)))
        got = tp.sample_select(_t(u), n_avail)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got.min() >= 0 and got.max() < n_avail


@pytest.mark.parametrize("origin", [(3, 5), np.array([[2.0, 7.0], [0.5, 1.5]], np.float32)])
def test_crop_coords_match_jax(origin):
    """An (y0, x0) pair, or one origin per row of the batch."""
    from oryon_tpu.geometry import coords as jc
    from oryon_tpu_torch.geometry import coords as tc

    c = np.random.RandomState(8).randint(0, 100, (2, 6, 2))
    o = origin if isinstance(origin, tuple) else origin[:, None]
    ref = jc.crop_coords(jnp.array(c), o)
    got = tc.crop_coords(_t(c), o)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = tc.decrop_coords(got, o)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jc.decrop_coords(ref, o)))
    np.testing.assert_array_equal(back.numpy(), c.astype(np.float32))


def test_kabsch_matches_jax_by_the_geodesic_bound():
    """Unweighted fit, one cloud and a batch, noisy targets."""
    from oryon_tpu.geometry.kabsch import kabsch as ref_fn
    from oryon_tpu_torch.geometry.kabsch import kabsch

    rs = np.random.RandomState(9)
    Ts = np.stack([_pose(rs) for _ in range(4)])
    A = rs.randn(4, 30, 3).astype(np.float32)
    Bm = np.einsum("bij,bnj->bni", Ts[:, :3, :3], A) + Ts[:, None, :3, 3]
    Bm = (Bm + 0.01 * rs.randn(*Bm.shape)).astype(np.float32)
    for a, b in ((A, Bm), (A[0], Bm[0])):
        ref = np.asarray(ref_fn(jnp.array(a), jnp.array(b)))
        got = kabsch(_t(a), _t(b)).numpy()
        assert got.shape == ref.shape
        assert rotation_angle(got[..., :3, :3], ref[..., :3, :3]).max() < 1e-3
        assert np.abs(got[..., :3, 3] - ref[..., :3, 3]).max() < 1e-4


@pytest.mark.parametrize("with_init", [False, True])
def test_icp_matches_jax_by_the_geodesic_bound(with_init):
    """The JAX test's case (200 points, 0.05 rad about z, a small shift),
    from identity and from a start; both recover the rotation to 1e-3."""
    from oryon_tpu.geometry.kabsch import icp as ref_fn
    from oryon_tpu_torch.geometry.kabsch import icp

    rs = np.random.RandomState(10)
    A = rs.randn(200, 3).astype(np.float32)
    ang = 0.05
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                  np.float32)
    Bm = A @ Rz.T + np.array([0.01, -0.02, 0.005], np.float32)
    init = None
    if with_init:
        init = _pose(rs, t_scale=0.01, angle=0.02)
    ref = np.asarray(ref_fn(jnp.array(A), jnp.array(Bm),
                            None if init is None else jnp.array(init)))
    got = icp(_t(A), _t(Bm), None if init is None else _t(init)).numpy()
    assert rotation_angle(got[:3, :3], ref[:3, :3]) < 1e-3
    assert np.abs(got[:3, 3] - ref[:3, 3]).max() < 1e-4
    np.testing.assert_allclose(got[:3, :3], Rz, atol=1e-3)
