"""The port's depth rasterisers (``oryon_tpu_torch/eval/renderer.py``)
against the JAX package's on the CPU: meshes of a few hundred faces, 128 x
128 frames, windows of 64-96 px.  The images are held at the JAX tests' own
bounds for two renders of one surface (``tests/test_renderer_evaluator.py``):
coverage differs on at most max(4, 0.2%) silhouette pixels, the median
depth difference is under 1e-3 mm and at most 4 pixels differ by more than
0.01 mm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

K = np.array([[500.0, 0, 64], [0, 500.0, 64], [0, 0, 1]], np.float32)
HW = (128, 128)


def icosphere(r=20.0, levels=2):
    """Octahedron subdivided ``levels`` times onto a sphere (8 * 4^levels faces)."""
    V = [[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0], [0, 0, r], [0, 0, -r]]
    F = [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]]
    for _ in range(levels):
        cache, newF = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(V[i]) + np.array(V[j])) / 2
                V.append((m / np.linalg.norm(m) * r).tolist())
                cache[key] = len(V) - 1
            return cache[key]
        for a, b, c in F:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            newF += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        F = newF
    return np.array(V, np.float32), np.array(F, np.int32)


def _rot(rs):
    q = rs.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def _poses(n, seed=0):
    rs = np.random.RandomState(seed)
    Rs = np.stack([_rot(rs) for _ in range(n)])
    ts = np.stack([[rs.uniform(-15, 15), rs.uniform(-15, 15), rs.uniform(350, 600)]
                   for _ in range(n)]).astype(np.float32)
    return Rs, ts


@pytest.fixture(scope="module")
def meshes():
    from oryon_tpu.eval.renderer import pad_mesh as jpad
    from oryon_tpu_torch.eval.renderer import pad_mesh

    V, F = icosphere()
    return jpad(V, F, n_faces=136), pad_mesh(V, F, n_faces=136)   # 128 faces + 8 pads


def _close_images(got, ref):
    """The JAX tests' bounds for two renders of one surface."""
    both = (got > 0) & (ref > 0)
    either = (got > 0) | (ref > 0)
    assert either.sum() > 0
    assert (either & ~both).sum() <= max(4, 0.002 * either.sum())
    diff = np.abs(got[both] - ref[both])
    assert np.median(diff) < 1e-3 and (diff > 0.01).sum() <= 4


@pytest.mark.parametrize("max_edge", [None, 12.0])
def test_pad_mesh_matches_jax(max_edge):
    from oryon_tpu.eval.renderer import pad_mesh as jpad
    from oryon_tpu_torch.eval.renderer import pad_mesh

    V, F = icosphere(levels=1)
    ref = jpad(V, F, n_faces=None if max_edge else 40, max_edge=max_edge)
    got = pad_mesh(V, F, n_faces=None if max_edge else 40, max_edge=max_edge)
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(ref.vertices))
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(ref.faces))
    np.testing.assert_array_equal(got.face_valid.numpy(), np.asarray(ref.face_valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_depth_matches_jax(meshes, seed):
    """The full-frame scatter z-buffer, one pose at a time."""
    from oryon_tpu.eval.renderer import render_depth as jrender
    from oryon_tpu_torch.eval.renderer import render_depth, render_depth_batch

    jmesh, mesh = meshes
    Rs, ts = _poses(2, seed)
    ref = np.stack([np.asarray(jrender(jmesh, jnp.asarray(R), jnp.asarray(t), jnp.asarray(K),
                                       HW, tile=32)) for R, t in zip(Rs, ts)])
    got = render_depth_batch(mesh, torch.from_numpy(Rs), torch.from_numpy(ts),
                             torch.from_numpy(K), HW, tile=32).numpy()
    for g, r in zip(got, ref):
        _close_images(g, r)
    one = render_depth(mesh, torch.from_numpy(Rs[0]), torch.from_numpy(ts[0]),
                       torch.from_numpy(K), HW, tile=32).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_affine_bbox_and_footprint_match_jax(meshes):
    from oryon_tpu.eval import renderer as jr
    from oryon_tpu_torch.eval import renderer as tr

    jmesh, mesh = meshes
    Rs, ts = _poses(3, 2)
    ts[2, 2] = -400.0     # behind the camera: nothing renders
    for R, t in zip(Rs, ts):
        jargs = (jnp.asarray(R), jnp.asarray(t), jnp.asarray(K))
        targs = (torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(K))
        jc, jf, _, _ = jr._face_affine(jmesh, *jargs)
        tc, tf, _, _ = tr._face_affine(mesh, *targs)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_allclose(tc.numpy(), np.stack([np.asarray(c) for c in jc], -1),
                                   rtol=1e-5, atol=1e-6)
        for g, r in zip(tr.projected_bbox(mesh, *targs, HW), jr.projected_bbox(jmesh, *jargs, HW)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(float(tr.max_screen_footprint(mesh, *targs)),
                                   float(jr.max_screen_footprint(jmesh, *jargs)), rtol=1e-5)


@pytest.mark.parametrize("window", [64, 96])
def test_render_depth_window_matches_jax(meshes, window):
    """The gather render in a window at the clipped bbox corner, for three
    poses in one batched call: the JAX render's bounds, the same output at
    every chunk (the face walk is a maximum), and the same window as the
    scatter render's crop."""
    from oryon_tpu.eval import renderer as jr
    from oryon_tpu_torch.eval import renderer as tr

    jmesh, mesh = meshes
    Rs, ts = _poses(3, 3 + window)
    Kt = torch.from_numpy(K).expand(3, 3, 3)
    lo, _, _ = tr.projected_bbox(mesh, torch.from_numpy(Rs), torch.from_numpy(ts), Kt, HW)
    origin = torch.minimum(lo.clamp(min=0), torch.tensor([HW[0] - window, HW[1] - window],
                                                         dtype=torch.float32)).long()
    outs = [tr.render_depth_window(mesh, torch.from_numpy(Rs), torch.from_numpy(ts), Kt,
                                   origin, (window, window), chunk).numpy()
            for chunk in (7, 64, 512)]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])
    for i in range(3):
        ref = np.asarray(jr.render_depth_window(
            jmesh, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), jnp.asarray(K),
            jnp.asarray(origin[i].numpy().astype(np.int32)), (window, window)))
        _close_images(outs[0][i], ref)
        full = tr.render_depth(mesh, torch.from_numpy(Rs[i]), torch.from_numpy(ts[i]),
                               torch.from_numpy(K), HW, tile=32).numpy()
        y, x = origin[i].tolist()
        crop = full[y:y + window, x:x + window]
        assert (full > 0).sum() == (crop > 0).sum()
        _close_images(outs[0][i], crop)
