"""Workers of tests/test_torch_port_tensor_parallel.py: each runs on every
rank of a data 2 x model 2 mesh of processes joined by gloo over a file
store, on the CPU, with the model axis sharding features at least
``TP_MIN`` wide (the small models are narrow).

Imports torch and the port only (no JAX, nothing of the conftest), so the
spawned children start quickly.  ``run`` writes the payload to the test's
directory, spawns the ranks and returns what each rank's worker returned.
"""

import os
from unittest import mock

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from byogan_tpu_torch.models.critic import Critic
from byogan_tpu_torch.models.generator import Generator
from byogan_tpu_torch.parallel import tensor
from byogan_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_train_state
from byogan_tpu_torch.train import loop, steps
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import create_train_state

DATA, MODEL = 2, 2
TP_MIN = 32


def run(directory: str, payload: dict) -> list:
    """``work`` on the mesh's ranks with ``payload``; the ranks' results."""
    torch.save(payload, os.path.join(directory, "payload.pt"))
    world = DATA * MODEL
    mp.spawn(_entry, args=(world, directory), nprocs=world, join=True)
    return [torch.load(os.path.join(directory, f"out{r}.pt"), weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
        with mock.patch.object(tensor, "TP_MIN_FEATURES", TP_MIN):
            out = work(rank, payload)
        torch.save(out, os.path.join(directory, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _errors(fn, *args) -> str:
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return ""


def work(rank: int, payload: dict) -> dict:
    out = {"errors": [_errors(make_mesh, 3, 2, "cpu"), _errors(make_mesh, None, 3, "cpu")]}
    mesh = make_mesh(DATA, MODEL, device="cpu")
    out["mesh"] = (mesh.global_rank, mesh.rank, mesh.model_rank, mesh.size, mesh.model_size)
    out["roundtrip"] = roundtrip_case(mesh, **payload["roundtrip"])
    out["layers"] = [layer_case(mesh, **case) for case in payload["layers"]]
    out["steps"] = [step_case(mesh, **case) for case in payload["steps"]]
    out["train"] = train_case(**payload["train"])
    return out


def _nets(gen_tables, critic_tables):
    return Generator(*gen_tables[0], **gen_tables[1]), Critic(*critic_tables)


def roundtrip_case(mesh, gen_tables, critic_tables, gen_state, critic_state):
    """Each net loaded from its shard of the full state, then gathered."""
    got = {}
    for name, net, full in zip(("gen", "critic"), _nets(gen_tables, critic_tables), (gen_state, critic_state)):
        tensor.shard_module_(net, mesh)
        net.load_state_dict(tensor.shard_state_dict(full, mesh.model_rank, MODEL), strict=True)
        got[name] = tensor.gather_state_dict(net, mesh)
        got[f"{name}_shapes"] = {n: tuple(p.shape) for n, p in net.named_parameters()}
    return got


def _grads_in_full_layout(net, mesh) -> dict:
    """The net's gradients made whole over the model group and gathered to
    the full layout."""
    tensor.reduce_model_grads_(net, mesh)
    return tensor.gather_named({n: p.grad for n, p in net.named_parameters()}, net.tp_shards, mesh)


def layer_case(mesh, net, tables, state, layer, inputs, wrt):
    """One layer (``layer``, a submodule's name) of a sharded net (``net``
    "gen" or "critic", built from ``tables`` and loaded from the full
    ``state``): its forward on ``inputs``, the gradient
    of ``sum(y cos y)`` with respect to the inputs ``wrt`` names, and the
    parameter gradient of that loss plus the squared input gradient (R1's
    double backward), made whole and gathered."""
    model = (Generator if net == "gen" else Critic)(*tables[0], **tables[1])
    model.load_state_dict(state)
    tensor.shard_module_(model, mesh)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    args = {k: (v.clone().requires_grad_(k in wrt) if isinstance(v, torch.Tensor) else v) for k, v in inputs.items()}
    y = model.get_submodule(layer)(*args.values())
    if isinstance(y, tuple):
        y = torch.cat(y, dim=1)
    loss = (y * torch.cos(y)).sum()
    gx = torch.autograd.grad(loss, [args[k] for k in wrt], create_graph=True)
    total = loss + sum(g.square().sum() for g in gx)
    params = list(model.parameters())
    for p, g in zip(params, torch.autograd.grad(total, params, allow_unused=True)):
        if g is not None:
            p.grad.copy_(g)
    return {"y": y.detach(), "gx": [g.detach() for g in gx], "grads": _grads_in_full_layout(model, mesh)}


def step_case(mesh, config, gen_tables, critic_tables, gen_state, critic_state, stage, batch, fade_in, fade,
              iterations):
    """Whole train steps over the mesh from the given full state, each on
    its global batch and global draws; the metrics of each, the state after
    it gathered, and the shapes each rank holds."""
    cfg = TrainConfig(**config)
    gen, critic = _nets(gen_tables, critic_tables)
    gen.load_state_dict(gen_state)
    critic.load_state_dict(critic_state)
    state = shard_train_state(create_train_state(cfg, gen, critic, torch.device("cpu")), mesh)
    step = steps.make_train_step(cfg, stage, batch, fade_in, (fade,), fade, mesh=mesh)
    metrics = [{k: float(v) for k, v in step(state, shard_batch(real, mesh), draws).items()}
               for real, draws in iterations]
    nets = {"gen": state.gen, "critic": state.critic, "gen_ema": state.gen_ema}
    return {
        "metrics": metrics, "counters": (state.iters, state.im_count),
        **{k: tensor.gather_state_dict(net, mesh) for k, net in nets.items() if net is not None},
        "shapes": {k: {n: tuple(p.shape) for n, p in net.named_parameters()} for k, net in nets.items() if net is not None},
        **{k: float(getattr(state, k)) for k in ("aug_p", "rt_ema", "pl_ema") if getattr(state, k) is not None},
    }


def train_case(config, max_iters):
    """``train`` over the mesh, stopped after ``max_iters`` iterations."""
    state = loop.train(TrainConfig(**config), max_iters=max_iters, device="cpu")
    return {"iters": state.iters, "im_count": state.im_count, "stage": state.stage,
            "shapes": {n: tuple(p.shape) for n, p in state.gen.named_parameters()}}
