"""Parity of the PyTorch port's training machinery with the JAX package.

``tiny_oryon`` at f32 on the CPU, the same flax weights carried into the port
by ``from_jax_params`` and the same synthetic batch (bitwise equal in both
packages).  The tiny featmap (32²) is smaller than the negative pool, so the
loss draws nothing and both packages compute the same function.

Tolerances: the loss within 1e-5 relative; each gradient (and SGD update)
leaf within 1e-4 of its largest JAX value plus 1e-7 (f32 backward passes
through two towers in two summation orders).  The optimizer, the schedule
and the kernels' gradients are held in ``test_torch_train_ops.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, pallas_interpret, to_torch

KEY = jax.random.PRNGKey(0)
BATCH = dict(seed=0, batch=2, img_hw=(28, 28), n_corrs=32, n_prompts=8,
             context_len=16, vocab=600)


def _leaves_close(got: dict, ref: dict, rel: float, floor: float):
    """Every entry of ``ref`` (torch-named numpy arrays): max |got - ref| <=
    rel * max |ref| + floor; a missing or None entry of ``got`` is zero."""
    for name, r in ref.items():
        g = got.get(name)
        g = np.zeros_like(r) if g is None else g
        bound = rel * np.abs(r).max() + floor
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max(), bound)


def _torch_tree(tree) -> dict:
    from oryon_tpu_torch.models.convert import from_jax_params
    return {k: v.numpy() for k, v in from_jax_params(tree).items()}


_PARAMS = {}


def _models(train_towers: bool, batch_kw=BATCH):
    """(JAX model, its flax weights, the JAX batch, the port's model on the
    same weights); the weights depend on nothing but the seed, so their
    shapes are traced once a process."""
    from oryon_tpu.data.pair_batch import device_fields
    from oryon_tpu.data.synthetic import synthetic_pair_batch as jax_batch
    from oryon_tpu.models.oryon import tiny_oryon
    from oryon_tpu_torch.models import oryon as port

    jb = device_fields(jax_batch(**batch_kw))
    model = tiny_oryon(train_towers=train_towers)
    if "params" not in _PARAMS:
        _PARAMS["params"] = flax_params(model, 0, jb.anchor.rgb, jb.query.rgb, jb.prompt_ids)
    params = _PARAMS["params"]
    return model, params, jb, to_torch(port.tiny_oryon(train_towers=train_towers), params)


@pytest.mark.parametrize("train_towers", [False, True])
def test_loss_and_gradients_match_jax(train_towers):
    """``jax.value_and_grad`` of the JAX ``loss_and_metrics`` against the
    port's loss and ``backward``; with ``train_towers`` the JAX tower runs K1
    in Pallas interpret mode and differentiates it through its ``_bwd``, the
    port through ``MhaLanesFunction``.  Frozen towers get no gradient in
    either; the text tower never does."""
    from oryon_tpu.losses.feature_loss import FeatureLossConfig as JCfg
    from oryon_tpu.train import loss_and_metrics as jax_lm
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig
    from oryon_tpu_torch.train import loss_and_metrics

    model, params, jb, tm = _models(train_towers)
    with pallas_interpret():
        (loss, jm), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm(model, JCfg(), p, jb, KEY), has_aux=True))(params)
    got, metrics = loss_and_metrics(tm, FeatureLossConfig(), synthetic_pair_batch(**BATCH))
    got.backward()
    assert float(got) == pytest.approx(float(loss), rel=1e-5)
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    ref = _torch_tree(grads)
    port = {n: None if p.grad is None else p.grad.numpy() for n, p in tm.named_parameters()}
    _leaves_close(port, ref, 1e-4, 1e-7)
    for n, g in port.items():
        tower = n.split(".")[0]
        if tower == "vlm_text" or (tower in ("vlm_visual", "guidance") and not train_towers):
            assert g is None and not ref[n].any(), n
        elif tower in ("vlm_visual", "guidance") and "embedding" not in n:
            assert g is not None, n
    if train_towers:
        assert any(np.abs(port[n]).max() > 0 for n in port if n.startswith("vlm_visual"))
        assert any(np.abs(port[n]).max() > 0 for n in port if n.startswith("guidance"))


# The class transformer attends over one token (``fusion.ClassTransformerLayer``,
# T = 1): linear attention then gives v * QK / (QK + 1e-6), so its q and k
# projections get a gradient of about 1e-9 of v's in exact arithmetic, below
# f32 rounding; both packages compute it as the rounding residue of two
# cancelling terms.  Such a leaf is held to zero, in both packages, within
# the f32 rounding (eps) of the largest update in the tree.
ZERO_GRAD_LEAVES = ("class_transformer.q.", "class_transformer.k.")
TIE_EPS = 4       # a ReLU input within 4 eps of its tensor's max |x| of 0 is a tie
REF_THREADS = 8   # the thread count at which the port's update meets the bound as is
_JAX_STEP = {}


class _GatedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate):
        ctx.save_for_backward(gate)
        return x.clamp_min(0)

    @staticmethod
    def backward(ctx, g):
        (gate,) = ctx.saved_tensors
        return g * gate, None


class _TieReLU:
    """``F.relu`` with torch's values and derivative (1 where x > 0, else
    0), which records the derivative at the ties: the differentiated inputs
    within ``TIE_EPS`` eps of zero, where f32 rounding decides the side and
    either one-sided derivative is the gradient.  Given ``replay`` (the
    ``gates`` of a recording run, keyed by call and element), it uses those
    derivatives there instead, and checks that each is a tie here too."""

    def __init__(self, replay=None):
        self.replay, self.calls, self.gates = replay, 0, {}

    def __call__(self, x, inplace=False):
        i, self.calls = self.calls, self.calls + 1
        gate = (x > 0).to(x.dtype)
        if torch.is_grad_enabled() and x.requires_grad:
            a, flat = x.detach().abs().reshape(-1), gate.view(-1)
            tol = TIE_EPS * np.finfo(np.float32).eps * float(a.max())
            if self.replay is None:
                self.gates.update({(i, j): float(flat[j])
                                   for j in torch.nonzero(a <= tol).reshape(-1).tolist()})
            else:
                for (c, j), g in self.replay.items():
                    if c == i:
                        assert float(a[j]) <= tol, (c, j, float(a[j]), tol)
                        flat[j] = g
        return _GatedReLU.apply(x, gate)


def _step_misses(update: dict, ref: dict, before: dict, rmax: float) -> list:
    """Leaves whose update misses its bound: ``ZERO_GRAD_LEAVES`` |d| and |r|
    within eps x the tree's largest |r|; every other leaf |d - r| within
    1e-4 max|r| + 2 ulp of the leaf's largest value."""
    eps, misses = np.finfo(np.float32).eps, []
    for n, d in update.items():
        r = ref[n] - before[n]
        if any(z in n for z in ZERO_GRAD_LEAVES):
            err, bound = max(np.abs(d).max(), np.abs(r).max()), eps * rmax
        else:
            err = np.abs(d - r).max()
            bound = 1e-4 * np.abs(r).max() + 2 * eps * np.abs(before[n]).max()
        if not err <= bound:
            misses.append((n, float(err), float(bound)))
    return misses


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_accumulated_step_matches_jax_on_mixed_validity(threads, monkeypatch):
    """``accum_steps=2`` on a batch of 4 with an invalid pair and a pair with
    half its correspondences invalid: the metrics and the update equal the
    JAX package's, the mean of micro-batch means (here 1/2, 1/4, 1/4 for the
    three valid pairs, where a validity-weighted mean would give 1/3 each).
    Plain SGD at LR 10 makes the update -10 times the mean gradient, read
    through the f32 rounding of the parameters (2 ulp of the leaf's largest
    value on top of the gradient bound).  At each of torch's intra-op thread
    counts: the summation order moves a ReLU input that is a tie (within f32
    rounding of 0) to either side.  At ``REF_THREADS`` the port's update meets
    the bound as it is computed; the other counts replay that run's one-sided
    derivatives at its ties (two ReLU inputs of the decoder, of shapes
    [4, 32, 32, 32] and [4, 8, 8, 64], are 8.5e-7 and 8.6e-7 at 8 threads,
    -2.7e-8 and -1.5e-7 at 1 thread)."""
    from oryon_tpu.losses.feature_loss import FeatureLossConfig as JCfg
    from oryon_tpu.train import TrainState, jit_train_step
    from oryon_tpu.train import make_optimizer as jax_make
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.train import create_train_state, make_train_step

    kw = dict(BATCH, seed=3, batch=4)
    model, params, jb, tm = _models(False, kw)
    valid = np.array([1, 0, 1, 1], np.float32)
    cv = np.asarray(jb.corr_valid).copy()
    cv[2, ::2] = False
    opt = dict(lr=10.0, weight_decay=0.0, total_steps=10, optim_type="SGD")
    if not _JAX_STEP:
        jb = jb._replace(valid=jnp.asarray(valid), corr_valid=jnp.asarray(cv))
        tx = jax_make(params, **opt)
        js = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params), tx=tx, model=model, loss_cfg=JCfg())
        js, jm = jit_train_step(donate=False, accum_steps=2)(js, jb, KEY)
        _JAX_STEP.update(step=int(js.step), metrics={k: float(v) for k, v in jm.items()},
                         params=_torch_tree(js.params))
    before, ref = _torch_tree(params), _JAX_STEP["params"]
    rmax = max(np.abs(ref[n] - before[n]).max() for n in ref)
    assert any(any(z in n for z in ZERO_GRAD_LEAVES) for n in ref)
    weights = {k: v.clone() for k, v in tm.state_dict().items()}

    def port_step(relu):
        tm.load_state_dict(weights)
        monkeypatch.setattr(torch.nn.functional, "relu", relu)
        tb = synthetic_pair_batch(**kw)
        tb = tb._replace(valid=torch.from_numpy(valid), corr_valid=torch.from_numpy(cv))
        ts, tmx = make_train_step(accum_steps=2)(create_train_state(tm, **opt), tb)
        assert ts.step == _JAX_STEP["step"] == 1
        for k, v in _JAX_STEP["metrics"].items():
            assert float(tmx[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
        return {n: t.detach().numpy() - before[n] for n, t in tm.named_parameters()}

    default = torch.get_num_threads()
    try:
        if "gates" not in _JAX_STEP:
            torch.set_num_threads(REF_THREADS)
            relu = _TieReLU()
            misses = _step_misses(port_step(relu), ref, before, rmax)
            assert not misses, (f"{REF_THREADS} threads", misses)
            _JAX_STEP["gates"] = relu.gates
        if threads != REF_THREADS:
            torch.set_num_threads(threads)
            misses = _step_misses(port_step(_TieReLU(_JAX_STEP["gates"])), ref, before, rmax)
            assert not misses, (_JAX_STEP["gates"], misses)
    finally:
        torch.set_num_threads(default)


def test_frozen_and_trained_towers_in_the_train_step():
    """The port's train step alone: frozen towers do not change and the
    fusion and decoder do; with ``train_towers`` the vision and Swin towers
    change too and the text tower never."""
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.train import create_train_state, make_train_step

    batch = synthetic_pair_batch(**BATCH)
    for train_towers in (False, True):
        model = random_init_(tiny_oryon(train_towers=train_towers),
                             torch.Generator().manual_seed(0))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(model, lr=1e-3, total_steps=5)
        step = make_train_step()
        for _ in range(2):
            state, m = step(state, batch, torch.Generator().manual_seed(0))
        assert state.step == 2 and torch.isfinite(m["loss/total"])
        moved = {n.split(".")[0] for n, p in model.named_parameters()
                 if not torch.equal(p.detach(), before[n])}
        want = {"fusion", "decoder"} | ({"vlm_visual", "guidance"} if train_towers else set())
        assert moved == want, (train_towers, moved)


def test_train_text_cache_equals_the_text_tower():
    """Cached rows equal the text tower's output; a second call (a hit)
    returns the same rows; a train step's loss with the cache equals the
    loss without it."""
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch
    from oryon_tpu_torch.losses.feature_loss import FeatureLossConfig
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.pipeline import make_train_text_cache
    from oryon_tpu_torch.train import loss_and_metrics

    model = random_init_(tiny_oryon(), torch.Generator().manual_seed(1))
    batch = synthetic_pair_batch(**dict(BATCH, seed=2))
    cache = make_train_text_cache(model)
    ids = batch.prompt_ids.numpy()
    emb = cache(ids)
    torch.testing.assert_close(emb, model.encode_prompts(batch.prompt_ids), rtol=0, atol=0)
    assert torch.equal(cache(batch.prompt_ids), emb)
    mixed = cache(np.concatenate([ids[1:], ids[:1]]))
    assert torch.equal(mixed, emb.flip(0))
    plain, _ = loss_and_metrics(model, FeatureLossConfig(), batch)
    cached, _ = loss_and_metrics(model, FeatureLossConfig(),
                                 batch._replace(text_emb=emb, prompt_ids=None))
    assert float(cached) == pytest.approx(float(plain), rel=1e-6)
