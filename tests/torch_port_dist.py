"""Workers of tests/test_torch_port_parallel.py: each runs on every rank of
a group of processes joined by gloo over a file store, on the CPU.

Imports torch and the port only (no JAX, nothing of the conftest), so the
spawned children start quickly.  ``run`` writes the payload to the test's
directory, spawns the ranks and returns what each rank's worker returned.
"""

import os
import signal
from unittest import mock

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from byogan_tpu_torch.models.critic import Critic
from byogan_tpu_torch.models.generator import Generator
from byogan_tpu_torch.models.layers import MinibatchStdDev
from byogan_tpu_torch.parallel.mesh import (
    agree,
    all_reduce_mean_,
    make_mesh,
    shard_batch,
    shard_train_state,
)
from byogan_tpu_torch.train import loop, losses, steps
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import create_train_state


def run(world: int, directory: str, payload: dict) -> list:
    """``work`` on ``world`` ranks with ``payload``; the ranks' results."""
    torch.save(payload, os.path.join(directory, "payload.pt"))
    mp.spawn(_entry, args=(world, directory), nprocs=world, join=True)
    return [torch.load(os.path.join(directory, f"out{r}.pt"), weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
        out = work(rank, payload)
        torch.save(out, os.path.join(directory, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def work(rank: int, payload: dict) -> dict:
    mesh = make_mesh(dist.get_world_size(), device="cpu")
    out = {"agree": (agree(rank == 1, mesh), agree(False, mesh))}
    out["stddev"] = [stddev_case(mesh, **case) for case in payload["stddev"]]
    out["steps"] = [step_case(mesh, **case) for case in payload["steps"]]
    out["train"] = train_case(rank, **payload["train"])
    return out


def stddev_case(mesh, x, critic_state, critic_tables, real, fake, c_lambda):
    """The layer's forward and input gradient on this rank's rows of the
    global batch ``x`` (NCHW), and R1's parameter gradient of a critic
    whose stddev spans the ranks, averaged over them."""
    layer = MinibatchStdDev()
    layer.mesh = mesh
    xl = shard_batch(x, mesh).clone().requires_grad_(True)
    y = layer(xl)
    (gx,) = torch.autograd.grad((y * torch.cos(y)).sum(), xl)
    critic = Critic(*critic_tables)
    critic.load_state_dict(critic_state)
    critic.use_mesh(mesh)
    crit = lambda im: critic(im, 1, None)  # noqa: E731
    loss, _ = losses.critic_r1_loss(crit, shard_batch(real, mesh), shard_batch(fake, mesh), c_lambda)
    params = list(critic.parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    all_reduce_mean_(grads, mesh)
    return {"y": y.detach(), "gx": gx, "grads": dict(zip([n for n, _ in critic.named_parameters()], grads))}


def step_case(mesh, config, gen_tables, critic_tables, gen_state, critic_state, stage, batch, fade_in, fade,
              iterations):
    """Whole train steps over the mesh from the given state, each on its
    global batch and global draws; the metrics of each and the state after."""
    cfg = TrainConfig(**config)
    gen, critic = Generator(*gen_tables[0], **gen_tables[1]), Critic(*critic_tables)
    gen.load_state_dict(gen_state)
    critic.load_state_dict(critic_state)
    state = create_train_state(cfg, gen, critic, torch.device("cpu"))
    if mesh.rank == 1:  # the broadcast replaces what the other ranks hold
        with torch.no_grad():
            for p in state.gen.parameters():
                p.add_(1.0)
        state.iters = 99
    shard_train_state(state, mesh)
    step = steps.make_train_step(cfg, stage, batch, fade_in, (fade,), fade, mesh=mesh)
    metrics = [{k: float(v) for k, v in step(state, shard_batch(real, mesh), draws).items()}
               for real, draws in iterations]
    return {
        "metrics": metrics, "gen": state.gen.state_dict(), "critic": state.critic.state_dict(),
        "counters": (state.iters, state.im_count),
        **{k: float(getattr(state, k)) for k in ("aug_p", "rt_ema", "pl_ema") if getattr(state, k) is not None},
    }


def train_case(rank, config, signal_rank, signal_iter):
    """``train`` over the mesh; rank ``signal_rank`` sends itself SIGTERM
    after iteration ``signal_iter``."""
    make_step = loop.make_train_step

    def signalling(*args, **kw):
        step = make_step(*args, **kw)

        def run_step(state, real, draws=None):
            out = step(state, real, draws)
            if rank == signal_rank and state.iters == signal_iter:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return run_step

    with mock.patch.object(loop, "make_train_step", signalling):
        state = loop.train(TrainConfig(**config), device="cpu")
    return {"iters": state.iters, "im_count": state.im_count, "epoch": state.epoch,
            "gen": state.gen.state_dict(), "critic": state.critic.state_dict()}
