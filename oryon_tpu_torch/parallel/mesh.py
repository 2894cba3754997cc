"""Process groups, the (data, model) device mesh and data placement.

Counterpart of ``oryon_tpu/parallel/mesh.py`` in PyTorch's idiom: one
process per device, launched by ``torchrun`` (or spawned by a test), each
running the same program on its part.  A ``Mesh`` lays the ranks out as a
``data x model`` grid, row-major as ``jax.sharding.Mesh`` does: rank
``d * n_model + m`` sits at (d, m).  Batches are split over ``data``;
parameters are replicated, except the tensor-parallel shards of
``parallel/tp.py``, which are split over ``model``.

Every call of ``torch.distributed`` in the port is in this package.  The
backend is the caller's choice (``init_distributed``): NCCL on the card by
default and gloo on the CPU.  Gloo takes CUDA tensors in every collective
used here (all-reduce SUM / MAX over float and int32, all-gather, broadcast),
which is how two ranks share one card, where NCCL refuses them.  A failed
initialisation or collective raises; nothing falls back to another backend
or to the CPU.

The autograd-aware collectives at the end are Megatron's conjugate pairs:
``copy_to_group`` (identity forward, all-reduce backward) in front of a
column-parallel layer, ``reduce_from_group`` (all-reduce forward, identity
backward) behind a row-parallel one, and ``scatter_to_group`` (own slice
forward, all-gather backward) in front of a row-parallel layer whose input is
replicated.  Each rank's loss is one copy of the same objective, so the
backward of an all-reduce must not sum the copies' gradients again, which is
what ``torch.distributed.nn.functional.all_reduce`` would do.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the job: 1 when the process is not distributed."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's global rank; before it joins the group, the rank that
    torchrun gave it (``RANK``), else 0."""
    return dist.get_rank() if is_distributed() else int(os.environ.get("RANK", 0))


def is_rank0() -> bool:
    return rank() == 0


@contextlib.contextmanager
def rank0_output():
    """Standard output goes nowhere on every rank but 0 (the CLIs' rule:
    rank 0 alone prints)."""
    if rank() == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def launched() -> bool:
    """True in a process that ``torchrun`` started (it sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Join the job's default process group and return this rank's device.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT`` as torchrun sets them; ``init_method`` (e.g.
    ``file://...``, as tests rendezvous), ``rank`` and ``world_size`` replace
    them.  On ``device="cuda"`` the rank uses ``cuda:<local_rank>`` (default
    ``LOCAL_RANK``) and the backend defaults to NCCL; on the CPU to gloo.
    A process already in a group keeps it."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
        out = torch.device("cuda", local_rank)
    else:
        out = torch.device(dev_type)
    if not is_distributed():
        if backend is None:
            backend = "nccl" if dev_type == "cuda" else "gloo"
        kw = {}
        if rank is not None:
            kw["rank"] = rank
        if world_size is not None:
            kw["world_size"] = world_size
        dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    return out


def shutdown() -> None:
    """Leave the default process group (a no-op outside one)."""
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


class Mesh:
    """The (data, model) grid of the job's ranks and its two process groups:
    ``data_group`` joins the ranks that hold the same parameters (the same
    model coordinate), ``model_group`` those that hold the same rows.
    ``device_type`` is the ranks' ("cuda" or "cpu")."""

    def __init__(self, n_data: int, n_model: int, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(device_type, (n_data, n_model),
                                            mesh_dim_names=("data", "model"))
        self.shape = {"data": n_data, "model": n_model}
        self.data_group = self.device_mesh.get_group("data")
        self.model_group = self.device_mesh.get_group("model")
        self.data_rank = self.device_mesh.get_local_rank("data")
        self.model_rank = self.device_mesh.get_local_rank("model")

    def batch_rows(self, B: int, accum_steps: int = 1) -> np.ndarray:
        return batch_rows(B, self.data_rank, self.shape["data"], accum_steps)


def make_mesh(n_data: int = -1, n_model: int = 1, *, device) -> Mesh:
    """``data x model`` mesh over every rank of the job; ``n_data=-1`` means
    all ranks // ``n_model``, as ``oryon_tpu.parallel.make_mesh``.  The mesh
    lies on the type of ``device``, the ranks' device (``--device cpu`` on a
    machine with a card gives a CPU mesh)."""
    n = world_size()
    if n_data == -1:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh data={n_data} model={n_model} needs "
                         f"{n_data * n_model} ranks; the job has {n}")
    return Mesh(n_data, n_model, torch.device(device).type)


def serving_mesh(n_data: int, n_model: int, batch_size: int,
                 label: str = "eval", *, device) -> Optional[Mesh]:
    """The eval / serving mesh policy of ``oryon_tpu.parallel.serving_mesh``,
    with "devices" read as the job's ranks: None (single-device) for a
    process that is not distributed or a job of one rank, and, with a
    WARNING, when the mesh needs more ranks than the job has or the batch
    does not divide over ``data``.  Callers with ``n_model > 1`` apply
    ``shard_params_tp`` themselves; ``device`` as for ``make_mesh``."""
    n_dev = world_size()
    if n_dev <= 1:
        return None
    n_model = max(1, n_model)
    eff_data = n_data if n_data != -1 else n_dev // n_model
    if eff_data < 1 or eff_data * n_model > n_dev:
        print(f"WARNING: mesh data={n_data} model={n_model} needs "
              f"{max(eff_data, 1) * n_model} devices but only {n_dev} "
              f"available; running single-device")
        return None
    mesh = make_mesh(n_data, n_model, device=device)
    if batch_size % mesh.shape["data"] != 0:
        print(f"WARNING: batch_size {batch_size} not divisible by data axis "
              f"{mesh.shape['data']}; running single-device")
        return None
    print(f"{label} mesh: data={mesh.shape['data']} "
          f"model={mesh.shape['model']}")
    return mesh


def batch_rows(B: int, data_rank: int, n_data: int, accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch of B that data rank ``data_rank`` of
    ``n_data`` holds, in its order: its 1/n_data of each of the
    ``accum_steps`` global micro-batches (rows ``[i B/a, (i+1) B/a)``), so
    its i-th local micro-batch is its part of the i-th global one."""
    if B % (accum_steps * n_data):
        raise ValueError(f"batch size {B} does not divide into {accum_steps} "
                         f"micro-batches over {n_data} data ranks")
    m, micro = B // (accum_steps * n_data), B // accum_steps
    return np.concatenate([np.arange(i * micro + data_rank * m,
                                     i * micro + (data_rank + 1) * m)
                           for i in range(accum_steps)])


def take_rows(tree: Any, rows: np.ndarray, B: int) -> Any:
    """Rows ``rows`` of every tensor or array field with leading size B of a
    (nested) NamedTuple; other fields pass through."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(take_rows(f, rows, B) for f in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim >= 1 and tree.shape[0] == B:
        if isinstance(tree, np.ndarray):
            return tree[rows]
        contiguous = rows.size == 0 or np.array_equal(rows, np.arange(rows[0], rows[0] + rows.size))
        if contiguous:
            return tree[int(rows[0]): int(rows[0]) + rows.size]
        return tree[torch.as_tensor(rows, device=tree.device)]
    return tree


def shard_batch(batch: Any, mesh: Mesh, accum_steps: int = 1) -> Any:
    """This rank's rows (``batch_rows``) of a global batch, every field
    with the batch's leading size (tensors, host arrays, nested
    NamedTuples)."""
    B = batch.corrs.shape[0] if hasattr(batch, "corrs") else batch.shape[0]
    return take_rows(batch, mesh.batch_rows(B, accum_steps), B)


def _broadcast_(t: torch.Tensor, group=None) -> None:
    if group is None:
        dist.broadcast(t, src=0)
    else:
        dist.broadcast(t, group=group, group_src=0)


@torch.no_grad()
def replicate(module_or_state: Any) -> Any:
    """Every parameter and buffer of a module (or every tensor of a dict)
    broadcast from global rank 0, in place, so that a random init or a
    restore agrees on every rank.  Returns its argument."""
    tensors = (module_or_state.state_dict().values()
               if isinstance(module_or_state, torch.nn.Module)
               else module_or_state.values())
    for t in tensors:
        if isinstance(t, torch.Tensor):
            _broadcast_(t)
    return module_or_state


@torch.no_grad()
def place_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """``replicate`` every parameter and buffer except the tensor-parallel
    shards (``tp.shard_dims``), which differ over ``model``: those are
    broadcast over ``data`` from the first rank of the rank's data group.
    A blanket replicate would overwrite them with rank 0's shards."""
    from oryon_tpu_torch.parallel.tp import shard_dims

    shards = shard_dims(model)
    for name, t in model.state_dict().items():
        _broadcast_(t, mesh.data_group if name in shards else None)
    return model


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce over ``group`` (``op`` "sum" or "max")."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return t


def all_reduce_coalesced_(tensors, group) -> None:
    """SUM all-reduce of a list of same-dtype tensors as one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i: i + t.numel()].view_as(t))
        i += t.numel()


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_outputs(out: Any, mesh: Mesh) -> Any:
    """A NamedTuple of per-rank rows (``PipelineOutputs``) gathered over
    ``data`` into the global batch, on every rank, in row order (the batch
    was split by ``shard_batch`` with one micro-batch)."""
    return type(out)(*(None if f is None else all_gather(f, mesh.data_group)
                       for f in out))


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = group_size(group), group_rank(group)
        w = x.shape[-1] // n
        return x[..., r * w: (r + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=-1), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return _CopyToGroup.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward passes the gradient through."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce_(x.contiguous(), group)


def scatter_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/n slice of the last axis; the backward gathers the
    slices' gradients into the whole axis."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ScatterToGroup.apply(x, group)
    n, r = group_size(group), group_rank(group)
    w = x.shape[-1] // n
    return x[..., r * w: (r + 1) * w].contiguous()


def shard_index(full: int, n: int, r: int, parts: int = 1) -> torch.Tensor:
    """Indices of rank r's 1/n of an axis of size ``full`` made of ``parts``
    equal packed parts (q | k | v: parts=3): its contiguous 1/n chunk of
    each part, in part order."""
    if full % (parts * n):
        raise ValueError(f"axis of {full} does not split into {parts} parts over {n} ranks")
    size, w = full // parts, full // (parts * n)
    return torch.cat([torch.arange(p * size + r * w, p * size + (r + 1) * w)
                      for p in range(parts)])
