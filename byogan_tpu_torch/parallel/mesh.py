"""The ``("data", "model")`` mesh over processes (byogan_tpu/parallel/mesh.py).

JAX lays the global batch over a ``("data", "model")`` device mesh, shards
the widest weights over the model axis and lets XLA insert the gradient
``psum`` and the activation all-gathers.  Here one process drives one card,
``torch.distributed`` joins the processes, and the collectives are
explicit.  ``make_mesh(data, model)`` lays the ranks out as JAX's
``np.asarray(devices).reshape(data, model)`` does: global rank ``d*M + m``
is data rank ``d`` and model rank ``m``, so a model group is ``M``
consecutive ranks and a data group takes every ``M``-th.

* each data rank holds the contiguous row block of the global batch that
  ``P("data")`` gives it (``shard_batch``, ``Mesh.rows``); the model ranks
  of one data rank hold the same rows;
* ``shard_train_state`` broadcasts rank 0's state to every rank, then, at
  ``model > 1``, keeps on each rank its model rank's block of the leaves
  that ``parallel.tensor.sharding_for_param`` shards (JAX's
  ``sharding_for_leaf``), with their Adam moments and EMA shadows;
* after each ``autograd.grad`` the step averages the gradients over the
  data group in one flattened all-reduce (``all_reduce_mean_``), so every
  data rank applies the same update;
* the critic's minibatch-stddev, whose statistics span the global batch,
  sums across the data group through ``AllReduceSum``, an autograd Function
  whose backward is itself, so R1's double backward runs through it; the
  model axis's collectives are ``parallel.tensor``'s.

``DistributedDataParallel`` is not used: the step takes its gradients with
``torch.autograd.grad`` (R1 and PLR take inner gradients with
``create_graph``), which DDP does not support.  Only ``all_reduce``,
``broadcast`` and ``barrier`` are called, because gloo does those and not
``all_gather`` or ``reduce_scatter`` on CUDA tensors, and two ranks that
share one card can only use gloo: NCCL refuses two ranks on one device.
Host-side flags (``agree``, ``barrier``) go through a gloo group over every
rank, so they never wait for the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from byogan_tpu_torch.core.device import resolve_device
from byogan_tpu_torch.parallel import tensor as tp

#: the variables torchrun sets for each process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the ``("data", "model")`` mesh: its data
    ``rank`` of ``size`` and the data group (the processes that hold the
    same model rank), its ``model_rank`` of ``model_size`` and the model
    group (the processes that hold the same rows), the card it drives, its
    ``global_rank`` and a gloo group of every rank for host-side flags (the
    world group itself when that is gloo).  At ``model_size`` 1 the data
    group is the world group and ``model_group`` is None."""

    rank: int
    size: int
    device: torch.device
    group: Any
    host_group: Any
    model_rank: int = 0
    model_size: int = 1
    model_group: Any = None
    global_rank: int = 0

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def rows(self, batch: int) -> Tuple[int, int]:
        """This data rank's contiguous row block ``[lo, hi)`` of a global batch."""
        if batch % self.size:
            raise ValueError(f"batch {batch} is not divisible by the data-parallel axis ({self.size})")
        local = batch // self.size
        return self.rank * local, (self.rank + 1) * local


#: the mesh of the data axis alone (the name it had before the model axis)
DataMesh = Mesh


def _local_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _backend(dev: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(
    data: Optional[int] = None, model: int = 1, device: Optional[Union[str, torch.device]] = None
) -> Mesh:
    """The ``data x model`` mesh over the initialised process group, whose
    world size ``data * model`` must equal (``data`` defaults to the world
    size over ``model``).  Without a process group a mesh of more than one
    process raises; a mesh of one starts a one-process group (NCCL for a
    CUDA ``device``, gloo for the CPU), whose collectives have nothing to
    reduce across.  ``device`` (default ``cuda``, the current card) is the
    card this rank drives.  Every rank creates every data and model group,
    in the same order, as ``dist.new_group`` requires."""
    dev = _local_device(device)
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    if not dist.is_initialized():
        need = (data or 1) * model
        if need > 1:
            axes = f"data_axis={data}" if model == 1 else f"mesh {data or 1}x{model} (data_axis x model_axis)"
            raise ValueError(
                f"{axes} needs {need} processes in one process group, one per card: launch "
                f"`torchrun --nproc-per-node {need} -m byogan_tpu_torch.cli.main <section> --distributed` "
                "(or call byogan_tpu_torch.parallel.init_distributed first)"
            )
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data * model != world:
        if model == 1:
            raise ValueError(f"data_axis={data} must equal the world size ({world} processes)")
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} processes, one per card, and the process group "
            f"has {world}: data_axis x model_axis must equal the world size"
        )
    host_group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    if model == 1:
        return Mesh(rank, world, dev, dist.group.WORLD, host_group, global_rank=rank)
    data_rank, model_rank = divmod(rank, model)
    data_group = model_group = None
    for m in range(model):  # the data groups, one per model rank
        g = dist.new_group([d * model + m for d in range(data)])
        data_group = g if m == model_rank else data_group
    for d in range(data):  # the model groups, one per data rank
        g = dist.new_group([d * model + m for m in range(model)])
        model_group = g if d == data_rank else model_group
    return Mesh(data_rank, data, dev, data_group, host_group, model_rank, model, model_group, rank)


def init_distributed(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group of a ``torchrun`` launch from its ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
    return this process's device: ``cuda:LOCAL_RANK`` (made the current card
    before the group) joined over NCCL, or the CPU for ``device="cpu"``
    over gloo.  Two processes never share a card: a ``LOCAL_RANK`` without
    its own card raises."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment ({', '.join(missing)} unset): launch with "
            "`torchrun --nproc-per-node N -m byogan_tpu_torch.cli.main <section> --distributed`"
        )
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card of its own ({count} visible): start at most {count} "
                "processes per node (--nproc-per-node)"
            )
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    dist.init_process_group(_backend(dev), init_method="env://", rank=rank, world_size=world)
    return dev


def _flat_groups(tensors: Sequence[torch.Tensor], device: torch.device) -> List[Tuple[List[torch.Tensor], torch.Tensor]]:
    """The tensors grouped by dtype, each group with one flat buffer of
    their values on ``device``."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [
        (ts, torch.cat([t.detach().reshape(-1).to(device) for t in ts]))
        for ts in by_dtype.values()
    ]


def _unflatten_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    views = [f.view_as(t) for t, f in zip(tensors, flat.split([t.numel() for t in tensors]))]
    with torch.no_grad():
        if all(t.device == flat.device for t in tensors):
            torch._foreach_copy_(tensors, views)
        else:
            for t, v in zip(tensors, views):
                t.copy_(v)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the data group: one all-reduce
    (sum) of a flattened buffer per dtype, divided by the data axis's size."""
    for ts, flat in _flat_groups(tensors, mesh.device):
        dist.all_reduce(flat, group=mesh.group)
        _unflatten_(ts, flat.div_(mesh.size))


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite each tensor with global rank ``src``'s on every rank: one
    broadcast of a flattened buffer per dtype on the mesh's device (CPU
    tensors, such as Adam's step counts and the RNG state, go through it
    too)."""
    for ts, flat in _flat_groups(list(tensors), mesh.device):
        dist.broadcast(flat, src)
        _unflatten_(ts, flat)


class AllReduceSum(torch.autograd.Function):
    """``x`` summed over the data group.  The sum of every data rank's loss
    depends on each rank's ``x`` through it, so its gradient is the sum of
    the ranks' upstream gradients: the backward is the same Function, which
    makes it differentiable to any order (R1's double backward through the
    critic's minibatch-stddev)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return AllReduceSum.apply(grad, ctx.mesh), None


def agree(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on any (a MAX all-reduce on
    the host group): every rank stops at the same iteration boundary."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (on the host group); nothing without a mesh."""
    if mesh is not None:
        dist.barrier(group=mesh.host_group)


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous row block of a global NHWC batch, as
    ``P("data")`` lays it out."""
    lo, hi = mesh.rows(batch.shape[0])
    return batch[lo:hi]


def _optimizer_tensors(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


def shard_train_state(state: Any, mesh: Mesh) -> Any:
    """Replicate ``state`` (a ``TrainState``) from rank 0: parameters and
    buffers of both nets and the EMA generator, both optimizers' moments
    and step counts, ``aug_p``, ``rt_ema``, ``pl_ema``, the counters and the
    RNG state.  At ``mesh.model_size > 1`` each rank then keeps its block of
    the leaves the model axis shards (``parallel.tensor.shard_module_``,
    features at least ``tensor.TP_MIN_FEATURES`` wide), of their gradients
    and Adam moments, and of the EMA's.  The critic's minibatch-stddev takes ``mesh``, so its
    statistics span the global batch.  Returns ``state``, changed in place."""
    tensors: List[torch.Tensor] = []
    for net in (state.gen, state.critic, state.gen_ema):
        if net is not None:
            tensors += list(net.parameters()) + list(net.buffers())
    for opt in (state.gen_opt, state.critic_opt):
        tensors += _optimizer_tensors(opt)
    tensors += [t for t in (state.aug_p, state.rt_ema, state.pl_ema) if t is not None]
    rng = state.rng.get_state()
    counters = torch.tensor([state.iters, state.im_count, state.stage, state.epoch], dtype=torch.int64)
    broadcast_(tensors + [rng, counters], mesh)
    state.rng.set_state(rng)
    state.iters, state.im_count, state.stage, state.epoch = (int(v) for v in counters)
    if mesh.model_size > 1:
        for net, opt in ((state.gen, state.gen_opt), (state.critic, state.critic_opt), (state.gen_ema, None)):
            if net is not None:
                tp.shard_module_(net, mesh, opt)
    state.critic.use_mesh(mesh)
    return state
