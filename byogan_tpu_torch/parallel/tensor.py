"""The model axis: tensor parallelism over the model group
(byogan_tpu/parallel/mesh.py:63-147).

JAX shards a leaf on its output-feature dim over the ``"model"`` axis and
lets XLA insert the resharding.  Here each rank of a model group holds its
block of every sharded leaf, and the layers that own them are
column-parallel: each computes its block of output features from the full,
replicated input and gathers the blocks (``models/layers.py``).  Which
leaves are sharded is ``sharding_for_param``, the port's copy of JAX's
``sharding_for_leaf`` on the reference's torch names and layouts:

* linear weights (out, in) and conv kernels OIHW whose ``out`` is at least
  ``tp_min_features`` and divisible by the axis: dim 0;
* the mapping network's biases (``to_w_noise.0.layers.*.0.bias``) of the
  same widths: dim 0;
* everything else is replicated.  That includes the biases of the other
  layers, which JAX's code replicates (its docstring says they follow).

A rank's block of a leaf is rows ``[m*k, (m+1)*k)``, except the AdaIN
style weight (2C, style_dim), whose rows are [gamma; beta]: rank ``m``
holds [gamma block m; beta block m], so that the synthesis conv on its
channel block finds the gamma and beta of its channels without a gather.
``shard_state_dict`` and ``gather_state_dict`` move between a full,
reference-layout state and the blocks.

The collectives are four autograd Functions in two adjoint pairs, each
one's backward the other: ``GatherChannels`` (blocks to the full tensor,
through one all-reduce of a zero buffer that each rank fills with its
block) and ``SplitChannels`` (the full tensor to this rank's block);
``CopyToModel`` (the identity, whose backward sums the ranks' partial input
gradients) and ``ReduceFromModel`` (that sum).  A replicated tensor's
gradient is the same full tensor on every rank, so the second derivatives
that R1 and path-length regularization take through these Functions come
out replicated too.  bf16 and f16 go over the wire as f32: the gather stays
exact and the sum rounds once.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

#: Output features at least this wide are sharded (byogan_tpu/parallel/
#: mesh.py:36 ``_TP_MIN_FEATURES``); read at call time, so a test can lower it.
TP_MIN_FEATURES = 256

_MAPPING_BIAS = "to_w_noise."
_STYLE_WEIGHT = "adain.style.weight"


def sharding_for_param(
    name: str, shape: Sequence[int], model_size: int, tp_min_features: Optional[int] = None
) -> Optional[int]:
    """The dim along which the model axis shards the parameter ``name`` of
    ``shape`` (reference torch name and layout), or None where it is
    replicated: JAX's ``sharding_for_leaf`` (byogan_tpu/parallel/mesh.py:
    63-89) on the torch layouts, where ``out`` is dim 0."""
    tp_min = TP_MIN_FEATURES if tp_min_features is None else tp_min_features
    shape = tuple(shape)
    if model_size <= 1:
        return None
    if name.endswith("weight") and len(shape) in (2, 4):
        out = shape[0]
    elif name.endswith("bias") and len(shape) == 1 and name.startswith(_MAPPING_BIAS):
        out = shape[0]
    else:
        return None
    return 0 if out >= tp_min and out % model_size == 0 else None


def shard_rows(name: str, full: int, model_rank: int, model_size: int) -> torch.Tensor:
    """The rows of a sharded leaf ``name`` (``full`` rows) that model rank
    ``model_rank`` holds, in the order it holds them."""
    if name.endswith(_STYLE_WEIGHT):  # [gamma; beta]: both halves' block m
        c = full // 2
        if c % model_size:
            raise ValueError(f"{name}: {c} channels do not split over the model axis ({model_size})")
        k = c // model_size
        lo = model_rank * k
        return torch.cat([torch.arange(lo, lo + k), torch.arange(c + lo, c + lo + k)])
    k = full // model_size
    return torch.arange(model_rank * k, (model_rank + 1) * k)


def shard_state_dict(
    full: Mapping[str, torch.Tensor], model_rank: int, model_size: int, tp_min_features: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """A full reference-layout state dict (``generator_state_from_jax``, a
    ``.pth``'s ``gen``) cut to model rank ``model_rank``'s blocks."""
    out = {}
    for name, t in full.items():
        if sharding_for_param(name, t.shape, model_size, tp_min_features) is None:
            out[name] = t
        else:
            out[name] = t.index_select(0, shard_rows(name, t.shape[0], model_rank, model_size).to(t.device))
    return out


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` in the dtype that goes over the wire."""
    return x.to(_wire_dtype(x.dtype), memory_format=torch.contiguous_format, copy=True)


def _gather_rows(block: torch.Tensor, rows: torch.Tensor, full: int, mesh: Any) -> torch.Tensor:
    buf = block.new_zeros((full,) + tuple(block.shape[1:]), dtype=_wire_dtype(block.dtype))
    buf.index_copy_(0, rows.to(block.device), block.to(buf.dtype))
    dist.all_reduce(buf, group=mesh.model_group)
    return buf.to(block.dtype)


def _gather(x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * mesh.model_size
    buf = x.new_zeros(shape, dtype=_wire_dtype(x.dtype))
    buf.narrow(dim, mesh.model_rank * k, k).copy_(x)
    dist.all_reduce(buf, group=mesh.model_group)
    return buf.to(x.dtype)


class GatherChannels(torch.autograd.Function):
    """Each rank's block of ``x`` along ``dim``, concatenated in model-rank
    order: the full tensor on every rank of the model group.  Backward:
    ``SplitChannels``, this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
        ctx.dim, ctx.mesh = dim % x.dim(), mesh
        return _gather(x, ctx.dim, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return SplitChannels.apply(grad, ctx.dim, ctx.mesh), None, None


class SplitChannels(torch.autograd.Function):
    """This rank's block of a replicated ``x`` along ``dim``.  Backward:
    ``GatherChannels``, since every rank's block of the gradient is a part
    of the replicated tensor's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
        ctx.dim, ctx.mesh = dim % x.dim(), mesh
        k = x.shape[ctx.dim] // mesh.model_size
        return x.narrow(ctx.dim, mesh.model_rank * k, k).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return GatherChannels.apply(grad, ctx.dim, ctx.mesh), None, None


class CopyToModel(torch.autograd.Function):
    """A replicated ``x`` as the input of a column-parallel layer: the
    identity forward; backward ``ReduceFromModel``, the sum of the ranks'
    partial gradients, each from its block of outputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Any) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ReduceFromModel.apply(grad, ctx.mesh), None


class ReduceFromModel(torch.autograd.Function):
    """``x`` summed over the model group.  Backward: ``CopyToModel``, the
    identity (every rank's part enters the sum once)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Any) -> torch.Tensor:
        ctx.mesh = mesh
        buf = _wire(x)
        dist.all_reduce(buf, group=mesh.model_group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return CopyToModel.apply(grad, ctx.mesh), None


def copy_to_model(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``CopyToModel`` over ``mesh``'s model group; ``x`` where mesh is None."""
    return x if mesh is None else CopyToModel.apply(x, mesh)


def gather_channels(x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
    """``GatherChannels`` over ``mesh``'s model group; ``x`` where mesh is
    None."""
    return x if mesh is None else GatherChannels.apply(x, dim, mesh)


def local_rows(t: torch.Tensor, k: int, mesh: Any) -> torch.Tensor:
    """This rank's ``k`` rows of a replicated ``t`` (a column-parallel
    layer's bias or noise weight), or ``t`` where it is already the block
    or mesh is None."""
    return t if mesh is None or t.shape[0] == k else t.narrow(0, mesh.model_rank * k, k)


def local_style_rows(t: torch.Tensor, k: int, mesh: Any) -> torch.Tensor:
    """This rank's [gamma block; beta block] (2k rows) of a replicated AdaIN
    style bias [gamma; beta], or ``t`` where mesh is None."""
    if mesh is None:
        return t
    c, lo = t.shape[0] // 2, mesh.model_rank * k
    return torch.cat([t[lo:lo + k], t[c + lo:c + lo + k]])


def shard_module_(
    module: torch.nn.Module, mesh: Any, opt: Optional[torch.optim.Optimizer] = None
) -> torch.nn.Module:
    """Keep this rank's block of every leaf of ``module`` that the model
    axis shards, in place: the same ``Parameter`` objects, so an optimizer
    built on them stays theirs; their gradients (zeros) and, with ``opt``,
    Adam's moments are cut with them.  Each layer that owns a sharded
    weight takes ``mesh`` as its ``model_mesh`` and runs column-parallel.
    ``module.tp_shards`` maps each sharded leaf to its full row count and
    ``module.tp_partial`` lists the replicated leaves used on a block only,
    as each layer names them (its ``tp_block_params``)."""
    shards: Dict[str, int] = {}
    for name, p in module.named_parameters():
        if sharding_for_param(name, p.shape, mesh.model_size) is None:
            continue
        full = p.shape[0]
        rows = shard_rows(name, full, mesh.model_rank, mesh.model_size).to(p.device)
        had_grad = p.grad is not None
        with torch.no_grad():
            p.grad = None
            p.data = p.data.index_select(0, rows)
            if had_grad:
                p.grad = torch.zeros_like(p)
        state = opt.state.get(p, {}) if opt is not None else {}
        for key, v in state.items():
            if isinstance(v, torch.Tensor) and v.dim() == p.dim() and v.shape[0] == full:
                state[key] = v.index_select(0, rows)
        shards[name] = full
        module.get_submodule(name.rpartition(".")[0]).model_mesh = mesh
    partial = set()
    for prefix, layer in module.named_modules():
        for leaf in getattr(layer, "tp_block_params", lambda: ())():
            partial.add(f"{prefix}.{leaf}" if prefix else leaf)
    module.tp_shards = shards
    module.tp_partial = frozenset(partial - set(shards))
    return module


def reduce_model_grads_(module: torch.nn.Module, mesh: Any) -> None:
    """Make each replicated leaf's gradient whole and equal on every rank of
    the model group, in one flattened all-reduce: the leaves used on a
    block only (``tp_partial``) are summed; the ones every rank used whole
    are averaged, which leaves them as they are up to rounding but
    bit-equal across the ranks.  A sharded leaf's gradient is its block's
    and stays."""
    shards, partial = getattr(module, "tp_shards", {}), getattr(module, "tp_partial", frozenset())
    summed, averaged = [], []
    for name, p in module.named_parameters():
        if name in shards or p.grad is None:
            continue
        (summed if name in partial else averaged).append(p.grad)
    grads = summed + averaged
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.model_group)
    n = sum(g.numel() for g in summed)
    flat[n:].div_(mesh.model_size)
    with torch.no_grad():
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def gather_named(
    tensors: Mapping[str, torch.Tensor], shards: Mapping[str, int], mesh: Any
) -> Dict[str, torch.Tensor]:
    """Named tensors of a module's leaves (its state dict, its gradients)
    with the sharded ones (``shards``, a module's ``tp_shards``) gathered to
    their full layout, on every rank of the model group: one all-reduce per
    sharded leaf, and every rank must call it."""
    out = {}
    for name, t in tensors.items():
        full = shards.get(name)
        if full is None:
            out[name] = t
        else:
            out[name] = _gather_rows(t, shard_rows(name, full, mesh.model_rank, mesh.model_size), full, mesh)
    return out


def gather_state_dict(module: torch.nn.Module, mesh: Any) -> Dict[str, torch.Tensor]:
    """``module``'s state dict in the full reference layout
    (``gather_named``): ``shard_state_dict``'s inverse.  Where nothing is
    sharded, the state dict's tensors (``mesh`` may then be None)."""
    return gather_named(module.state_dict(), getattr(module, "tp_shards", {}), mesh)


def gather_optimizer_state(opt: torch.optim.Optimizer, module: torch.nn.Module, mesh: Any) -> Dict[str, Any]:
    """``opt.state_dict()`` with the moments of ``module``'s sharded leaves
    gathered to their full layout (every rank must call it; ``mesh`` may be
    None where nothing is sharded); the live state is not touched."""
    state = opt.state_dict()
    shards = getattr(module, "tp_shards", {})
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for group in opt.param_groups for p in group["params"]]
    for index, name in enumerate(order):
        full, st = shards.get(name), state["state"].get(index)
        if full is None or st is None:
            continue
        rows = shard_rows(name, full, mesh.model_rank, mesh.model_size)
        state["state"][index] = {
            k: _gather_rows(v, rows, full, mesh) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
            for k, v in st.items()
        }
    return state
