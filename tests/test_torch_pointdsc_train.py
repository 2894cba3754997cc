"""PointDSC's training mode and ``oryon_tpu_torch.scripts.train_pointdsc``
against the JAX package's ``scripts/train_pointdsc.py`` on the CPU.

The train-mode taps (confidence logits before the validity mask, unit
features) and the per-problem BatchNorm with its running statistics match
the JAX ``vmap`` of ``model.apply(..., train=True)``; three train steps from
the same initial weights on the same problems give the JAX losses and the
JAX weights; the ``native.npz``
of either package loads bit-exact through the other's
``build_pointdsc_solver``.

Bounds: 1e-5 plus the reference's own rounding spread.  Train-mode
BatchNorm takes flax's variance E[x^2] - E[x]^2 in f32, and at these
weights the attention messages are nearly equal over a problem's rows, so
the variance cancels and the result moves by up to about 1e-3 with the
summation order (an f64 run of either package is 6e-4 to 8e-4 from its f32
run).  The JAX package run on the same problems with the rows of each
problem permuted (the same function: every layer is equivariant to the
rows) measures that spread; the port must lie within 1e-5 plus ``SPREAD``
times it.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, rotation_angle, to_torch

CFG = dict(num_layers=2)
N, B = 64, 4
SPREAD = 4.0
PERMS = [np.random.RandomState(40 + i).permutation(N) for i in range(3)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_pointdsc", os.path.join(ROOT, "scripts", "train_pointdsc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def init():
    from oryon_tpu.models.pointdsc import PointDSC, PointDSCConfig
    z = jnp.zeros((N, 3))
    model = PointDSC(PointDSCConfig(**CFG))
    variables = flax_params(model, 4, z, z, jnp.ones(N))
    # running statistics away from 0 / 1, so the momentum update shows
    rs = np.random.RandomState(5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rs.rand(*a.shape) * 0.5).astype(np.float32), variables["batch_stats"])
    return model, variables


def test_problem_draws_equal_the_jax_script():
    from oryon_tpu_torch.scripts import train_pointdsc as port
    ref = _jax_script().make_batch(np.random.RandomState(3), 5, 40)
    got = port.make_batch(np.random.RandomState(3), 5, 40)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_train_taps_and_batchnorm_match_jax(init):
    from oryon_tpu_torch.models.convert import to_jax_params
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.scripts.train_pointdsc import make_batch
    model, variables = init
    src, tgt, valid, _, _ = make_batch(np.random.RandomState(2), B, N)

    def one(s, t, v):
        _, taps = model.apply(variables, s, t, v, True,
                              mutable=["intermediates", "batch_stats"])
        inter = taps["intermediates"]
        return inter["confidence_logits"][0], inter["features"][0], taps["batch_stats"]

    run = jax.jit(jax.vmap(one))

    def reference(perm):
        logits, feats, stats = run(src[:, perm], tgt[:, perm], valid[:, perm])
        inv = np.argsort(perm)
        stats = _flat(jax.tree_util.tree_map(lambda x: np.asarray(x.mean(0)), stats))
        return {"logits": np.asarray(logits)[:, inv], "feats": np.asarray(feats)[:, inv],
                **stats}

    ref = reference(np.arange(N))
    spread = {k: max(np.abs(reference(p)[k] - v).max() for p in PERMS) for k, v in ref.items()}
    port = to_torch(PointDSC(PointDSCConfig(**CFG)), variables)
    got_logits, got_feats = port(*(torch.from_numpy(a) for a in (src, tgt, valid)), train=True)
    got = {"logits": got_logits.detach().numpy(), "feats": got_feats.detach().numpy(),
           **_flat(to_jax_params(port.state_dict())["batch_stats"], "")}
    for k, v in ref.items():
        assert np.abs(got[k] - v).max() <= 1e-5 + SPREAD * spread[k], (k, spread[k])
    # the taps are the training ones: padded rows keep finite logits
    assert (valid == 0).any() and np.isfinite(got["logits"]).all()
    # the running statistics moved from their start by flax's momentum rule
    start = _flat(variables["batch_stats"])
    assert all(np.abs(got[k] - start[k]).max() > 1e-4 for k in start)
    # eval mode is untouched by the taps: the solver still returns poses
    with torch.no_grad():
        T, _, conf = port(*(torch.from_numpy(a) for a in (src, tgt, valid)))
    assert T.shape == (B, 4, 4) and torch.isinf(conf[torch.from_numpy(valid) == 0]).all()


def test_single_pair_and_batched_entry_points_match_jax(init):
    """``get_pointdsc_pose`` (one pair, all rows valid by default) and
    ``batched_pointdsc`` give the JAX package's poses."""
    from oryon_tpu.models.pointdsc import batched_pointdsc as jbatched
    from oryon_tpu.models.pointdsc import get_pointdsc_pose as jpose
    from oryon_tpu_torch.models.pointdsc import (PointDSC, PointDSCConfig, batched_pointdsc,
                                                 get_pointdsc_pose)
    from oryon_tpu_torch.scripts.train_pointdsc import make_batch
    model, variables = init
    src, tgt, valid, _, _ = make_batch(np.random.RandomState(7), 2, N)
    port = to_torch(PointDSC(PointDSCConfig(**CFG)), variables)
    T1 = get_pointdsc_pose(port, torch.from_numpy(src[0]), torch.from_numpy(tgt[0])).numpy()
    ref1 = np.asarray(jpose(model, variables, jnp.asarray(src[0]), jnp.asarray(tgt[0])))
    T, _, conf = batched_pointdsc(port)(*(torch.from_numpy(a) for a in (src, tgt, valid)))
    ref, _, ref_conf = jbatched(model, variables)(src, tgt, valid)
    for got, want in ((T1[None], ref1[None]), (T.numpy(), np.asarray(ref))):
        assert rotation_angle(got[:, :3, :3], want[:, :3, :3]).max() < 1e-3
        assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() < 1e-4
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), atol=1e-4, rtol=1e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_three_train_steps_match_jax(init, tmp_path, monkeypatch):
    """The JAX script (its init replaced by the shared weights, its jitted
    step recorded) and the port's ``train`` on the same draws."""
    from oryon_tpu.models.pointdsc import PointDSC as JPointDSC
    from oryon_tpu_torch.models.convert import to_jax_params
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.pipeline import build_pointdsc_solver
    from oryon_tpu_torch.scripts.train_pointdsc import train
    _, variables = init
    monkeypatch.setattr(JPointDSC, "init", lambda self, *a, **k: jax.tree_util.tree_map(
        jnp.asarray, variables))
    recorded, real_jit = [], jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "train_step":
            return jitted

        def run(*args):
            out = jitted(*args)
            recorded.append([float(x) for x in out[3:6]])
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)

    def jax_run(name, perm=None):
        """(losses [3, 3], native.npz contents, directory) of the JAX script;
        ``perm`` permutes the rows of every training problem."""
        mod = _jax_script()
        if perm is not None:
            draw = mod.make_batch

            def make_batch(rng, b, n):
                src, tgt, valid, inlier, gt = draw(rng, b, n)
                return src[:, perm], tgt[:, perm], valid[:, perm], inlier[:, perm], gt
            mod.make_batch = make_batch
        del recorded[:]
        out = tmp_path / name
        mod.main(["steps=3", f"batch={B}", f"n={N}", "layers=2", "lr=1e-4", "seed=0",
                  f"out={out}", "device=cpu"])
        with np.load(out / "native.npz") as z:
            return np.asarray(recorded), {k: z[k] for k in z.files}, out

    ref_losses, ref, jdir = jax_run("jax")
    alt = [jax_run(f"perm{i}", p) for i, p in enumerate(PERMS)]
    monkeypatch.setattr(jax, "jit", real_jit)
    assert ref_losses.shape == (3, 3)
    loss_spread = max(np.abs(a[0] - ref_losses).max() for a in alt)

    port = to_torch(PointDSC(PointDSCConfig(**CFG)), variables)
    logs = []
    run = train(port, 3, B, N, 1e-4, 0, torch.device("cpu"), log=logs.append)
    assert np.abs(run.history[:, :3] - ref_losses).max() <= 1e-5 + SPREAD * loss_spread
    assert logs[0].startswith("step 0: loss ") and logs[-1].startswith("step 2: loss ")

    got = _flat(to_jax_params(port.state_dict()))
    start = _flat(variables)
    assert set(got) == set(ref) == set(start)
    for k in ref:
        upd = np.abs(ref[k] - start[k]).max()
        diff = np.abs(got[k] - ref[k]).mean()
        spread = np.mean([np.abs(a[1][k] - ref[k]).mean() for a in alt])
        assert diff <= 1e-5 * upd + SPREAD * spread, (k, upd, diff, spread)

    # the JAX script's file loads bit-exact through the port's solver builder
    pd = build_pointdsc_solver(str(jdir))
    assert pd.cfg.num_layers == 2
    for k, v in _flat(to_jax_params(pd.state_dict())).items():
        np.testing.assert_array_equal(v, ref[k])


def test_port_native_npz_loads_through_the_jax_builder(tmp_path, capsys):
    """The port's CLI writes the flax layout; the JAX package's
    ``build_pointdsc_solver`` reads the same bits."""
    from oryon_tpu.pipeline import build_pointdsc_solver as jbuild
    from oryon_tpu_torch.models.convert import to_jax_params
    from oryon_tpu_torch.scripts import train_pointdsc
    run = train_pointdsc.main(["steps=2", "batch=2", "n=32", "layers=2", f"out={tmp_path}",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1: loss" in out and "held-out (16 problems): R err mean" in out
    assert f"wrote {tmp_path}/native.npz" in out
    assert run.history.shape == (2, 4) and len(run.r_errs) == 16
    pd, pd_vars = jbuild(str(tmp_path), jax.random.PRNGKey(0), 32)
    assert pd.cfg.num_layers == 2
    ref = _flat(to_jax_params(run.model.state_dict()))
    got = _flat(jax.tree_util.tree_map(np.asarray, pd_vars))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
