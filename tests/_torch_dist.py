"""Rank bodies of the port's multi-process CPU tests.

Each test spawns its ranks with ``spawn`` (``torch.multiprocessing``, a
rendezvous through a file under the test's temporary directory, gloo, a
time limit).  A rank imports torch and the port only; the JAX references
are computed in the test's own process and the inputs travel as numpy
arrays and state dicts.  Rank 0 returns the body's result.
"""
import os
import time

import numpy as np
import torch

B_PIPE, IMG, DEPTH_HW, P, MAXC = 4, 64, (48, 64), 8, 64
ICP = dict(icp_refine=True, icp_points=128, icp_iters=6, icp_trim=0.6)
CAM = np.array([60.0, 0, 32.0, 0, 60.0, 24.0, 0, 0, 1], np.float32)
TRAIN_BATCH = dict(seed=3, batch=4, img_hw=(28, 28), n_corrs=32, n_prompts=8,
                   context_len=16, vocab=600)
SGD = dict(lr=10.0, weight_decay=0.0, total_steps=10, optim_type="SGD")


def _entry(rank, world, init, body, kwargs, out):
    from oryon_tpu_torch.parallel.mesh import init_distributed, shutdown

    init_distributed("cpu", "gloo", init, rank, world)
    try:
        res = globals()[body](**kwargs)
        if rank == 0:
            torch.save(res, out)
    finally:
        shutdown()


class Ranks:
    """``body(**kwargs)`` running on ``world`` gloo ranks; ``result()``
    waits (at most ``timeout`` seconds from the start) and returns rank 0's
    result.  The caller's process is free meanwhile (the JAX references)."""

    def __init__(self, world: int, body: str, kwargs: dict, tmp_dir, timeout: float = 150.0):
        import torch.multiprocessing as mp

        tmp_dir = str(tmp_dir)
        self.body, self.world, self.timeout = body, world, timeout
        self.out = os.path.join(tmp_dir, f"{body}.pt")
        self.deadline = time.monotonic() + timeout
        # the ranks share the host's cores with the caller and with each
        # other: idle OpenMP threads sleep instead of spinning (the number of
        # threads, and so the order of every sum, stays torch's default)
        policy = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            self.ctx = mp.start_processes(
                _entry, args=(world, f"file://{tmp_dir}/{body}.store", body, kwargs, self.out),
                nprocs=world, join=False, start_method="spawn")
        finally:
            if policy is None:
                del os.environ["OMP_WAIT_POLICY"]
            else:
                os.environ["OMP_WAIT_POLICY"] = policy

    def result(self):
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.body} on {self.world} ranks took over "
                                       f"{self.timeout} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return torch.load(self.out, weights_only=False)


def spawn(world: int, body: str, kwargs: dict, tmp_dir, timeout: float = 150.0):
    """Run ``body(**kwargs)`` on ``world`` gloo ranks; rank 0's result."""
    return Ranks(world, body, kwargs, tmp_dir, timeout).result()


class FakeTokenizer:
    """Ids inside the tiny model's 600-token vocabulary."""

    def __init__(self, *a):
        pass

    def __call__(self, texts, context_length=77):
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [598] + [ord(c) % 500 + 1 for c in t][:context_length - 2] + [599]
            out[i, :len(ids)] = ids
        return out


def pipe_views(rs, B=B_PIPE):
    return dict(
        rgb=(rs.rand(B, IMG, IMG, 3) * 255).astype(np.uint8),
        mask=(rs.rand(B, IMG, IMG) > 0.5).astype(np.uint8),
        depth=(rs.rand(B, *DEPTH_HW) * 300 + 600).astype(np.uint16),
        camera=np.tile(CAM, (B, 1)),
        pose=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        size=np.tile(np.array(DEPTH_HW, np.int32), (B, 1)))


def port_pipe_batch(a, q):
    from oryon_tpu_torch.data.pair_batch import PairBatch, PairView

    def t(x):
        return torch.from_numpy(np.array(x))

    def view(v):
        return PairView(rgb=t(v["rgb"]), mask=t(v["mask"]), depth=None,
                        orig_depth=t(v["depth"].astype(np.float32)), eval_depth=None,
                        camera=t(v["camera"]), pose=t(v["pose"]), size=t(v["size"]))
    B = a["rgb"].shape[0]
    return PairBatch(anchor=view(a), query=view(q), prompt_ids=None,
                     corrs=torch.zeros((B, MAXC, 4), dtype=torch.int64),
                     corr_valid=torch.zeros((B, MAXC), dtype=torch.bool),
                     valid=torch.ones(B), rel_pose=None,
                     cls_id=np.zeros(B, np.int64), instance_id=np.arange(B))


def tiny_model(sd, train_towers=False):
    from oryon_tpu_torch.models.oryon import tiny_oryon

    m = tiny_oryon(train_towers=train_towers)
    m.load_state_dict(sd)
    return m


def train_batch(valid, corr_valid, **kw):
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch

    b = synthetic_pair_batch(**dict(TRAIN_BATCH, **kw))
    return b._replace(valid=torch.from_numpy(valid), corr_valid=torch.from_numpy(corr_valid))


def sgd_step(sd, mesh, valid, corr_valid, accum, train_towers=False):
    """One plain-SGD step at LR 10 on the mixed-validity batch: (metrics,
    the unsharded weights after it)."""
    from oryon_tpu_torch.parallel.mesh import shard_batch
    from oryon_tpu_torch.parallel.tp import full_state_dict, shard_params_tp
    from oryon_tpu_torch.train import create_train_state, make_train_step

    model = shard_params_tp(tiny_model(sd, train_towers), mesh)
    state = create_train_state(model, **SGD)
    batch = shard_batch(train_batch(valid, corr_valid), mesh, accum)
    state, metrics = make_train_step(accum_steps=accum, mesh=mesh)(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in full_state_dict(model).items()})


def dp_suite(sd, pd_sd, pd_cfg, views, text, noise, valid, corr_valid):
    """2 data ranks: the mesh rules, build_pipeline (given noise and drawn
    noise) and the SGD step with 1 and 2 micro-batches."""
    import torch.distributed as dist

    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig
    from oryon_tpu_torch.ops.matching import MatchParams
    from oryon_tpu_torch.parallel.mesh import make_mesh
    from oryon_tpu_torch.pipeline import Noise, PipelineConfig, build_pipeline

    res = {}
    mesh = make_mesh(-1, 1, device="cpu")
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, (mesh.data_rank, mesh.model_rank))
    res["coords"] = coords
    res["shape"] = mesh.shape
    res["tp_shape"] = make_mesh(-1, 2, device="cpu").shape
    try:
        make_mesh(3, 1, device="cpu")
        res["bad_mesh"] = None
    except ValueError as e:
        res["bad_mesh"] = str(e)
    # the mesh lies on the ranks' device, whether or not a card is visible
    visible = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        res["mesh_device"] = [mesh.device_mesh.device_type,
                              make_mesh(-1, 1, device="cpu").device_mesh.device_type]
    finally:
        torch.cuda.is_available = visible

    model = tiny_model(sd).eval()
    pd = PointDSC(PointDSCConfig(**pd_cfg))
    pd.load_state_dict(pd_sd)
    cfg = PipelineConfig(solver="pointdsc", match=MatchParams(max_corrs=MAXC), **ICP)
    run = build_pipeline(model, cfg, pd.eval(), mesh)
    batch = port_pipe_batch(*views)
    out = run(batch, torch.from_numpy(text),
              noise=Noise(*(None if n is None else torch.from_numpy(n) for n in noise)))
    res["pipe"] = {k: v.numpy() for k, v in out._asdict().items()}
    out = run(batch, torch.from_numpy(text), generator=torch.Generator().manual_seed(5))
    res["pipe_gen"] = {k: v.numpy() for k, v in out._asdict().items()}

    for accum in (1, 2):
        res[f"train{accum}"] = sgd_step(sd, mesh, valid, corr_valid, accum)
    return res


def tp_suite(sd, swin_sd, clip_sd, clip_cfg, x_swin, x_clip, a, q, ids, valid, corr_valid,
             exp_root):
    """2 model ranks: the tiny model's forward (f32), the int8 Swin and CLIP
    towers, and a checkpoint of a sharded train state saved and restored."""
    import dataclasses

    from oryon_tpu_torch import checkpoint as ckpt
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.models.clip import ClipVisionConfig, ClipVisionTower
    from oryon_tpu_torch.models.quant import QuantRowParallelDense
    from oryon_tpu_torch.models.swin import SwinConfig, SwinGuidance
    from oryon_tpu_torch.parallel.mesh import make_mesh
    from oryon_tpu_torch.parallel.tp import shard_dims, shard_params_tp
    from oryon_tpu_torch.train import create_train_state, make_train_step

    mesh = make_mesh(1, 2, device="cpu")
    res = {}
    model = shard_params_tp(tiny_model(sd), mesh).eval()
    res["shards"] = shard_dims(model)
    res["heads"] = (model.vlm_visual.resblocks[0].attn.heads,
                    model.guidance.stage2_block0.attn.heads)
    with torch.no_grad():
        out = model(*(torch.from_numpy(t) for t in (a, q, ids)))
    res["forward"] = [t.numpy() for t in out]

    swin = SwinGuidance(SwinConfig(quant="int8"), dtype=torch.float32)
    swin.load_state_dict(swin_sd)
    shard_params_tp(swin, mesh)
    clip = ClipVisionTower(ClipVisionConfig(**clip_cfg, quant="int8"), dtype=torch.float32)
    clip.load_state_dict(clip_sd)
    shard_params_tp(clip, mesh)
    res["int8_rows"] = sum(isinstance(m, QuantRowParallelDense)
                           for t in (swin, clip) for m in t.modules())
    with torch.no_grad():
        res["swin"] = [t.numpy() for t in swin(torch.from_numpy(x_swin))]
        res["clip"] = clip(torch.from_numpy(x_clip)).numpy()

    # a sharded SGD-with-momentum state: saved unsharded, restored re-sharded
    cfg = dataclasses.replace(load_config(None, []), exp_root=exp_root, exp_name="tp")
    model = shard_params_tp(tiny_model(sd), mesh)
    state = create_train_state(model, lr=1e-3, optim_type="SGD", momentum=0.9,
                               weight_decay=0.0, total_steps=10)
    state, _ = make_train_step(mesh=mesh)(state, train_batch(valid, corr_valid))
    ckpt.init_experiment(cfg)
    res["saved"] = ckpt.save_train_state(cfg, 0, state)
    fresh = shard_params_tp(tiny_model(sd), mesh)
    fstate = create_train_state(fresh, lr=1e-3, optim_type="SGD", momentum=0.9,
                                weight_decay=0.0, total_steps=10)
    res["restored_epoch"] = ckpt.restore_train_state(cfg, fstate, "last")
    res["restored_equal"] = (
        all(torch.equal(a_, b_) for a_, b_ in zip(model.state_dict().values(),
                                                  fresh.state_dict().values()))
        and all(torch.equal(state.optimizer.state[p]["momentum_buffer"],
                            fstate.optimizer.state[fp]["momentum_buffer"])
                for p, fp in zip(model.parameters(), fresh.parameters())
                if p in state.optimizer.state)
        and fstate.step == state.step == 1)
    return res


def dp_tp_suite(sd, valid, corr_valid):
    """4 ranks as data 2 x model 2: the SGD step, frozen and trained towers."""
    from oryon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, device="cpu")
    return {"frozen": sgd_step(sd, mesh, valid, corr_valid, 1),
            "towers": sgd_step(sd, mesh, valid, corr_valid, 1, train_towers=True)}


def cli_suite(train_args, resume_args, test_args):
    """2 data ranks: run_train_torch.main for 2 steps, its resume, and
    run_test_torch.main; the CLI objects' plain results."""
    import run_test_torch
    import run_train_torch
    from oryon_tpu_torch.models import tokenizer

    tokenizer.ClipTokenizer = FakeTokenizer
    tr = run_train_torch.main(train_args)
    res = {"train_step": tr.state.step, "train_mesh": tr.mesh.shape}
    tr = run_train_torch.main(resume_args)
    res["resume_step"] = tr.state.step
    sw = run_test_torch.main(test_args)
    res["test_n"], res["csv"] = sw.n, getattr(sw, "csv", None)
    return res


def take(batch, rows: slice):
    """Rows of every field of a (nested) NamedTuple batch."""
    if batch is None:
        return None
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(take(f, rows) for f in batch))
    return batch[rows]


