"""The port's BOP pose errors (``oryon_tpu_torch/eval/bop.py``) and symmetry
sets (``data/bop.py``) against the JAX package's on the CPU, at a few
hundred model points: MSSD and MSPD within 1e-5 (relative), recalls and
symmetry sets equal, VSD errors within 5e-3 (the JAX tests' bound between
two VSD computations), and the batched calls equal to one pose at a time.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_renderer import HW, K, _poses, icosphere

INFOS = {"asym": {},
         "disc": {"symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]},
         "cont": {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                  "symmetries_discrete": [[1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1]]}}


@pytest.mark.parametrize("kind", list(INFOS))
def test_sym_set_matches_jax(kind):
    from oryon_tpu.data.bop import sym_set_from_info as jsym
    from oryon_tpu_torch.data.bop import sym_set_from_info

    np.testing.assert_array_equal(sym_set_from_info(INFOS[kind], 0.05),
                                  jsym(INFOS[kind], 0.05))


@pytest.mark.parametrize("kind", list(INFOS))
def test_mssd_mspd_match_jax(kind):
    """Four estimated poses near four GT poses, batched in the port and one
    at a time in JAX, under the class's symmetry set."""
    from oryon_tpu.eval import bop as jb
    from oryon_tpu_torch.data.bop import sym_set_from_info
    from oryon_tpu_torch.eval import bop as tb

    rs = np.random.RandomState(1)
    pts = (rs.randn(300, 3) * 40).astype(np.float32)
    syms = sym_set_from_info(INFOS[kind], 0.05)
    Rg, tg = _poses(4, 5)
    Re, te = _poses(4, 6)
    te = (tg + rs.randn(4, 3) * 5).astype(np.float32)
    T = [torch.from_numpy(a) for a in (Re, te, Rg, tg)]
    Kb = torch.from_numpy(K).expand(4, 3, 3)
    got_s = tb.mssd(*T, torch.from_numpy(pts), torch.from_numpy(syms)).numpy()
    got_p = tb.mspd(*T, Kb, torch.from_numpy(pts), torch.from_numpy(syms)).numpy()
    for i in range(4):
        J = [jnp.asarray(a[i]) for a in (Re, te, Rg, tg)]
        ref_s = float(jb.mssd(*J, jnp.asarray(pts), jnp.asarray(syms)))
        ref_p = float(jb.mspd(*J, jnp.asarray(K), jnp.asarray(pts), jnp.asarray(syms)))
        np.testing.assert_allclose(got_s[i], ref_s, rtol=1e-5)
        np.testing.assert_allclose(got_p[i], ref_p, rtol=1e-5)
        d = 86.6
        assert float(tb.mssd_recall(torch.tensor(got_s[i]), d)) == float(
            jb.mssd_recall(jnp.asarray(ref_s), d))
        assert float(tb.mspd_recall(torch.tensor(got_p[i]))) == float(
            jb.mspd_recall(jnp.asarray(ref_p)))


def test_recalls_and_thresholds_match_jax():
    """The three recalls on errors that straddle every threshold."""
    from oryon_tpu.eval import bop as jb
    from oryon_tpu_torch.eval import bop as tb

    errs = np.linspace(0.0, 60.0, 241).astype(np.float32)
    for d in (100.0, 86.6, 1.0):
        np.testing.assert_array_equal(
            tb.mssd_recall(torch.from_numpy(errs), d).numpy(),
            np.asarray([jb.mssd_recall(jnp.asarray(e), d) for e in errs]))
    np.testing.assert_array_equal(tb.mspd_recall(torch.from_numpy(errs)).numpy(),
                                  np.asarray([jb.mspd_recall(jnp.asarray(e)) for e in errs]))
    v = np.random.RandomState(2).rand(6, 10).astype(np.float32) * 0.6
    np.testing.assert_array_equal(tb.vsd_recall(torch.from_numpy(v)).numpy(),
                                  np.asarray([jb.vsd_recall(jnp.asarray(e)) for e in v]))


def _scene(mesh, R, t, rs):
    """A measured depth: the GT render over a background plane at 700 mm,
    with millimetre noise and a few holes."""
    from oryon_tpu_torch.eval.renderer import render_depth

    d = render_depth(mesh, torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(K),
                     HW, tile=32).numpy()
    d = np.where(d > 0, d, 700.0) + rs.randn(*HW) * 3
    d[rs.rand(*HW) < 0.02] = 0
    return np.clip(d, 0, None).astype(np.float32)


@pytest.mark.parametrize("window", [64, 96])
def test_vsd_errors_match_jax(window):
    """Windowed VSD of three estimated poses against the GT pose (the same
    renders handed to both packages), batched in the port: within 5e-3 of
    JAX; the full frame gives the same errors as the window (exactness)."""
    from oryon_tpu.eval import bop as jb
    from oryon_tpu_torch.eval import bop as tb
    from oryon_tpu_torch.eval.renderer import pad_mesh, render_depth, render_depth_window

    rs = np.random.RandomState(window)
    mesh = pad_mesh(*icosphere())
    Rg, tg = _poses(1, 9)
    Re = np.concatenate([Rg, _poses(2, 10)[0]])
    te = np.concatenate([tg, tg + [[4.0, 0, 0]], tg + [[0, 3.0, 20.0]]]).astype(np.float32)
    scene = _scene(mesh, Rg[0], tg[0], rs)
    origin = torch.tensor([[20, 24]] * 3)
    Kb = torch.from_numpy(K).expand(3, 3, 3)
    d_est = render_depth_window(mesh, torch.from_numpy(Re), torch.from_numpy(te), Kb, origin,
                                (window, window))
    d_gt = render_depth_window(mesh, torch.from_numpy(Rg).expand(3, 3, 3),
                               torch.from_numpy(tg).expand(3, 3), Kb, origin, (window, window))
    d_win = torch.from_numpy(scene[20:20 + window, 24:24 + window]).expand(3, window, window)
    taus = list(np.arange(0.05, 0.51, 0.05))
    got = tb.vsd_errors(d_est, d_gt, d_win, Kb, 15.0, taus, 40.0, origin=origin).numpy()
    assert got[0].max() < got[2].max()      # the moved pose scores worse
    for i in range(3):
        ref = np.asarray(jb.vsd_errors(jnp.asarray(d_est[i].numpy()), jnp.asarray(d_gt[i].numpy()),
                                       jnp.asarray(d_win[i].numpy()), jnp.asarray(K), 15.0, taus,
                                       40.0, origin=jnp.asarray([20, 24])))
        np.testing.assert_allclose(got[i], ref, atol=5e-3)
    # the full frame: the window held both renders, so nothing changes
    full = [render_depth(mesh, torch.from_numpy(Re[i]), torch.from_numpy(te[i]),
                         torch.from_numpy(K), HW, tile=32) for i in range(3)]
    full_gt = render_depth(mesh, torch.from_numpy(Rg[0]), torch.from_numpy(tg[0]),
                           torch.from_numpy(K), HW, tile=32)
    for i in range(3):
        e = tb.vsd_errors(full[i], full_gt, torch.from_numpy(scene), torch.from_numpy(K),
                          15.0, taus, 40.0).numpy()
        np.testing.assert_allclose(e, got[i], atol=5e-3)


def test_depth_to_dist_and_visibility_match_jax():
    from oryon_tpu.eval import bop as jb
    from oryon_tpu_torch.eval import bop as tb

    rs = np.random.RandomState(4)
    d = (rs.rand(40, 50) * 800).astype(np.float32)
    d[rs.rand(40, 50) < 0.3] = 0
    o = np.array([7, 11])
    got = tb.depth_to_dist(torch.from_numpy(d), torch.from_numpy(K), torch.from_numpy(o)).numpy()
    ref = np.asarray(jb.depth_to_dist(jnp.asarray(d), jnp.asarray(K), jnp.asarray(o)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    e = (d + rs.randn(40, 50) * 20).astype(np.float32)
    vg = tb.visib_mask_gt(torch.from_numpy(d), torch.from_numpy(e), 15.0)
    np.testing.assert_array_equal(vg.numpy(), np.asarray(jb.visib_mask_gt(d, e, 15.0)))
    np.testing.assert_array_equal(
        tb.visib_mask_est(torch.from_numpy(d), torch.from_numpy(e[::-1].copy()), vg, 15.0).numpy(),
        np.asarray(jb.visib_mask_est(d, e[::-1], np.asarray(vg.numpy()), 15.0)))
