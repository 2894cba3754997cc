"""The port's device mesh and data parallelism (``oryon_tpu_torch/parallel``)
against the JAX package, on the CPU with gloo ranks.

The mesh policy's printed lines are held verbatim against
``oryon_tpu/parallel/mesh.py``.  Two spawned ranks (``_torch_dist.py``,
torch and the port only) run ``build_pipeline`` and the train step over a
``data`` axis of 2; the JAX references are single-device runs in this
process on the same inputs (tiny_oryon in f32, flax weights bridged by
``from_jax_params``).

Bounds: the DP pipeline against the port's single-device run as
``tests/test_pipeline.py:281-286`` holds the JAX one (iou within 1e-5, poses
within 1e-4, ``corr_valid`` identical); against JAX the port's parity bounds
(masks and correspondences exact, poses within 1e-3 rad and 1e-4 m).  The DP
train step against JAX's single-device step: metrics within rel 1e-5, the
plain-SGD update at LR 10 within the bound of
``tests/test_torch_train.py::test_accumulated_step_matches_jax_on_mixed_validity``.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_helpers import rotation_angle
from test_torch_pipeline import slice_models  # noqa: F401  (module fixture)
from test_torch_train import KEY, _models, _torch_tree

FEAT_HW = 32 * 32
CAP = 1024


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


class _FakeMesh:
    def __init__(self, n_data, n_model):
        self.shape = {"data": n_data, "model": n_model}


@pytest.mark.parametrize("n_dev, n_data, n_model, batch", [
    (1, -1, 1, 8),      # one device: no mesh, no line
    (4, 8, 1, 8),       # a training mesh larger than the host
    (4, -1, 8, 8),      # a model axis larger than the host
    (4, 2, 4, 8),       # data x model larger than the host
    (4, -1, 1, 6),      # the batch does not divide over data
    (4, -1, 1, 8),      # the mesh line
    (4, 2, 2, 8),
])
def test_serving_mesh_policy_prints_the_jax_lines(monkeypatch, n_dev, n_data, n_model, batch):
    from oryon_tpu.parallel import mesh as jmesh
    from oryon_tpu_torch.parallel import mesh as tmesh

    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    ref, ref_out = _printed(lambda: jmesh.serving_mesh(n_data, n_model, batch, "eval"))
    monkeypatch.setattr(tmesh, "world_size", lambda: n_dev)
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda d, m, device: _FakeMesh(n_dev // m if d == -1 else d, m))
    got, got_out = _printed(lambda: tmesh.serving_mesh(n_data, n_model, batch, "eval",
                                                       device="cpu"))
    assert got_out == ref_out
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got.shape == dict(ref.shape)


@pytest.mark.parametrize("B, n, accum", [(8, 2, 1), (8, 2, 2), (12, 3, 2), (16, 4, 4), (4, 1, 2)])
def test_batch_rows_split_each_global_micro_batch(B, n, accum):
    """Rank r's i-th local micro-batch is its 1/n of the JAX reshape's i-th
    global micro-batch (rows [i B/a, (i+1) B/a)), and the ranks' rows
    partition the batch."""
    from oryon_tpu_torch.parallel.mesh import batch_rows

    micro = np.arange(B).reshape(accum, B // accum)      # the JAX reshape
    rows = [batch_rows(B, r, n, accum).reshape(accum, -1) for r in range(n)]
    for i in range(accum):
        np.testing.assert_array_equal(np.concatenate([r[i] for r in rows]), micro[i])
    with pytest.raises(ValueError):
        batch_rows(B + 1, 0, n, accum)


def _noise_from_keys(key, B):
    """The uniforms the JAX program draws from ``key`` for a batch of B, as
    numpy fields of the port's Noise (see test_torch_pipeline)."""
    keys = jax.random.split(key, 3 * B)
    src, out, ia, iq = [], [], [], []
    for b in range(B):
        k_src, k_out = jax.random.split(keys[b])
        src.append(jax.random.uniform(k_src, (FEAT_HW,)))
        out.append(jax.random.uniform(k_out, (CAP,), minval=1e-20, maxval=1.0))
        ka, kq = jax.random.split(keys[2 * B + b])
        ia.append(jax.random.uniform(ka, (FEAT_HW,)))
        iq.append(jax.random.uniform(kq, (FEAT_HW,)))
    st = [np.stack([np.asarray(x) for x in v]) for v in (src, out, ia, iq)]
    return (st[0], st[1], None, st[2], st[3])


def _jax_pipe_batch(a, q):
    from oryon_tpu.data.pair_batch import PairBatch, PairView

    def view(v):
        return PairView(rgb=jnp.array(v["rgb"]), mask=jnp.array(v["mask"]),
                        depth=None, orig_depth=jnp.array(v["depth"]),
                        eval_depth=None, camera=jnp.array(v["camera"]),
                        pose=jnp.array(v["pose"]), size=jnp.array(v["size"]))
    B = a["rgb"].shape[0]
    return PairBatch(anchor=view(a), query=view(q), prompt_ids=None,
                     corrs=jnp.zeros((B, td.MAXC, 4), jnp.int32),
                     corr_valid=jnp.zeros((B, td.MAXC), bool),
                     valid=np.ones(B, np.float32), rel_pose=None,
                     cls_id=np.zeros(B, np.int64), instance_id=np.zeros(B))


def _jax_pipe(slice_models, inputs):  # noqa: F811
    """JAX's single-device ``build_pipeline`` on the inputs, key 11."""
    from oryon_tpu.ops.matching import MatchParams as JMatch
    from oryon_tpu.pipeline import PipelineConfig as JCfg, build_pipeline as jbuild

    model, params, pd, pd_vars = slice_models[:4]
    jcfg = JCfg(solver="pointdsc", match=JMatch(max_corrs=td.MAXC), **td.ICP)
    return jbuild(model, params, jcfg, (pd, pd_vars))(
        jax.random.PRNGKey(11), _jax_pipe_batch(*inputs["views"]), jnp.array(inputs["text"]))


def _mixed_validity():
    """B=4 with pair 1 invalid and half of pair 2's correspondences invalid:
    rank 0 of 2 holds one valid pair (rows 0, 1), rank 1 two (rows 2, 3)."""
    from oryon_tpu.data.synthetic import synthetic_pair_batch

    cv = np.asarray(synthetic_pair_batch(**td.TRAIN_BATCH).corr_valid).copy()
    cv[2, ::2] = False
    return np.array([1, 0, 1, 1], np.float32), cv


@pytest.fixture(scope="module")
def dp(slice_models, tmp_path_factory):  # noqa: F811
    """Rank 0's results of ``_torch_dist.dp_suite`` on 2 ranks, with its
    inputs."""
    tmodel, tpd_model = slice_models[4:]
    _, params, _, _ = _models(False, td.TRAIN_BATCH)
    from oryon_tpu_torch.models.convert import from_jax_params

    rs = np.random.RandomState(0)
    views = (td.pipe_views(rs), td.pipe_views(rs))
    text = rs.randn(td.B_PIPE, td.P, 48).astype(np.float32)
    noise = _noise_from_keys(jax.random.PRNGKey(11), td.B_PIPE)
    valid, cv = _mixed_validity()
    inputs = dict(sd=from_jax_params(params), pd_sd=tpd_model.state_dict(),
                  pd_cfg=dict(num_layers=2, k=16), views=views, text=text, noise=noise,
                  valid=valid, corr_valid=cv)
    ranks = td.Ranks(2, "dp_suite", inputs, tmp_path_factory.mktemp("dp"))
    # the JAX references while the ranks run
    refs = {"pipe": _jax_pipe(slice_models, inputs)}
    for accum in (1, 2):
        _jax_sgd_step(accum)
    return inputs, ranks.result(), refs


def test_mesh_layout_over_two_ranks(dp):
    _, res, _ = dp
    assert res["shape"] == {"data": 2, "model": 1}
    assert res["coords"] == [(0, 0), (1, 0)]
    assert res["tp_shape"] == {"data": 1, "model": 2}
    assert "needs 3 ranks" in res["bad_mesh"]
    # ranks joined on the CPU get a CPU mesh even where a card is visible
    assert res["mesh_device"] == ["cpu", "cpu"]


def _single_device_pipe(slice_models, inputs, **kw):  # noqa: F811
    from oryon_tpu_torch.ops.matching import MatchParams
    from oryon_tpu_torch.pipeline import PipelineConfig, make_run_fn

    tmodel, tpd_model = slice_models[4:]
    cfg = PipelineConfig(solver="pointdsc", match=MatchParams(max_corrs=td.MAXC), **td.ICP)
    out = make_run_fn(tmodel, cfg, tpd_model)(td.port_pipe_batch(*inputs["views"]),
                                             torch.from_numpy(inputs["text"]), **kw)
    return {k: v.numpy() for k, v in out._asdict().items()}


def _same_as_single_device(got, ref):
    """tests/test_pipeline.py:281-286's bounds."""
    np.testing.assert_allclose(got["iou_a"], ref["iou_a"], atol=1e-5)
    np.testing.assert_allclose(got["iou_q"], ref["iou_q"], atol=1e-5)
    np.testing.assert_allclose(got["pred_pose"], ref["pred_pose"], atol=1e-4)
    np.testing.assert_array_equal(got["corr_valid"], ref["corr_valid"])


def test_dp_pipeline_matches_single_device_and_jax(dp, slice_models):  # noqa: F811
    """build_pipeline over 2 data ranks, B=4, PointDSC + ICP, the noise the
    JAX program draws: the single-device port's result, and JAX's."""
    from oryon_tpu_torch.pipeline import Noise

    inputs, res, refs = dp
    got = res["pipe"]
    noise = Noise(*(None if n is None else torch.from_numpy(n) for n in inputs["noise"]))
    _same_as_single_device(got, _single_device_pipe(slice_models, inputs, noise=noise))

    ref = refs["pipe"]
    for name in ("mask_a", "mask_q", "corr_valid", "detection_valid", "n_corrs"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)), err_msg=name)
    v = np.asarray(ref.corr_valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(got["corrs"][v], np.asarray(ref.corrs)[v])
    T, T_ref = got["pred_rel_pose"], np.asarray(ref.pred_rel_pose)
    assert rotation_angle(T[:, :3, :3], T_ref[:, :3, :3]).max() < 1e-3
    assert np.abs(T[:, :3, 3] - T_ref[:, :3, 3]).max() < 1e-4


def test_dp_pipeline_draws_the_global_batch_noise(dp, slice_models):  # noqa: F811
    """With a generator, each rank draws the noise of the global batch and
    keeps its rows: the single-device run of the same seed."""
    inputs, res, refs = dp
    ref = _single_device_pipe(slice_models, inputs, generator=torch.Generator().manual_seed(5))
    _same_as_single_device(res["pipe_gen"], ref)
    assert not np.array_equal(res["pipe_gen"]["corrs"], res["pipe"]["corrs"])


@functools.lru_cache(maxsize=None)
def _jax_sgd_step(accum):
    from oryon_tpu.losses.feature_loss import FeatureLossConfig as JCfg
    from oryon_tpu.train import TrainState, jit_train_step
    from oryon_tpu.train import make_optimizer as jax_make

    model, params, jb, _ = _models(False, td.TRAIN_BATCH)
    valid, cv = _mixed_validity()
    jb = jb._replace(valid=jnp.asarray(valid), corr_valid=jnp.asarray(cv))
    tx = jax_make(params, **td.SGD)
    js = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                    tx=tx, model=model, loss_cfg=JCfg())
    js, jm = jit_train_step(donate=False, accum_steps=accum)(js, jb, KEY)
    return _torch_tree(params), _torch_tree(js.params), {k: float(v) for k, v in jm.items()}


def _update_error(got: dict, before: dict, ref: dict, rel: float = 1e-4,
                  floor: float = 0.0) -> float:
    """The largest excess of |got - ref| over the update bound of
    test_torch_train (``rel`` of the leaf's largest reference update plus 2
    ulp of its largest weight, plus ``floor``); <= 0 when every leaf is
    within it."""
    worst = -np.inf
    for n, r in ref.items():
        d, u = got[n] - before[n], r - before[n]
        ulp = 2 * np.finfo(np.float32).eps * np.abs(before[n]).max()
        worst = max(worst, np.abs(d - u).max() - (rel * np.abs(u).max() + ulp + floor))
    return worst


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_train_step_matches_jax_on_mixed_validity(dp, accum):
    """2 data ranks, B=4, an invalid pair on rank 0: the loss is normalised
    over the global batch's valid pairs and each global micro-batch is split
    over the ranks, so the metrics and the plain-SGD update equal JAX's
    single-device step."""
    _, res, _ = dp
    metrics, after = res[f"train{accum}"]
    before, ref, jm = _jax_sgd_step(accum)
    for k, v in jm.items():
        assert metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert _update_error(after, before, ref) <= 0


def test_mean_of_rank_means_misses_the_bound():
    """What DDP would compute on the same batch: each rank's loss normalised
    over its own valid pairs and the gradients averaged.  Its update misses
    the bound that the global normaliser meets."""
    from oryon_tpu_torch.train import create_train_state, train_step

    before, ref, _ = _jax_sgd_step(1)
    valid, cv = _mixed_validity()
    batch = td.train_batch(valid, cv)
    sd = {k: torch.from_numpy(v) for k, v in before.items()}
    updates = []
    for rows in (slice(0, 2), slice(2, 4)):
        model = td.tiny_model(sd)
        state = create_train_state(model, **td.SGD)
        train_step(state, td.take(batch, rows))
        updates.append({k: v.numpy() for k, v in model.state_dict().items()})
    ddp = {k: 0.5 * (updates[0][k] + updates[1][k]) for k in ref}
    assert _update_error(ddp, before, ref) > 0
