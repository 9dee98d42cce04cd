"""The progressive training loop (byogan_tpu/train/loop.py:89-496).

Stage by stage, 4 px up to ``len(epoch_progression)`` stages: a fresh
loader per epoch, the fade-in span ``fade_in = fade_percentage * epochs *
n_batches`` (a batch count that divides an image count, the reference's
train.py:119 quirk, kept), per-repeat fade flags, a sample grid
``output/s-{iters}.png`` every ``display_step``, ``chk-{iters}.pth`` every
``checkpoint_step``, and ``FINAL.pth`` at the end.  ``max_iters`` stops
early with a checkpoint that resumes batch-exactly: the loader is seeded
per epoch and skips the batches already trained, and the checkpoint holds
the optimizers and the RNG.  SIGTERM or SIGINT stops the same way at the
next iteration boundary (``_graceful_stop``), so a preempted run loses
nothing; a resume checks the config's trajectory knobs against the
checkpoint's.  ``eval_step > 0`` logs SWD and MS-SSIM every ``eval_step``
iterations (``log_eval``) from draws of their own, so the training
trajectory is the same with and without it.

Each iteration is a named region of a profiler trace (``annotate``).

Data and model parallelism (``data_axis > 1`` or ``model_axis > 1``, or
any run inside a process group; byogan_tpu/train/loop.py:177-223,
328-373, 448-494): the loop builds the ``data x model`` mesh
(``parallel.make_mesh``), checks every stage's batch against the data
axis up front, replicates the built or restored state from rank 0 and cuts
the model axis's blocks (``shard_train_state``), and each data rank loads
and trains on its rows of every global batch; the model ranks of one data
rank load the same rows.  Global rank 0 alone writes: ``metrics.jsonl``,
the sample grids, the eval log and the console.  What runs a sharded net
runs on every rank that needs to enter its collectives: the sample grids
and the periodic eval run on the model group of rank 0 (data rank 0)
while the others wait at a barrier, and every rank gathers a checkpoint's
blocks, which rank 0 writes, between barriers.  The ranks agree on a
SIGTERM or SIGINT at every iteration boundary (``parallel.agree``), so all
stop at the same iteration and rank 0 saves one checkpoint, which resumes
batch-exactly in any number of processes and on any mesh.
"""

from __future__ import annotations

import collections
import contextlib
import os
import signal
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from byogan_tpu_torch.core.device import resolve_device
from byogan_tpu_torch.core.grids import make_grid, to_uint8, uint8_to_training_range
from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.data.pipeline import (
    batches_per_epoch,
    make_stage_loader,
    open_stage_dataset,
    to_device,
)
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.parallel.mesh import agree, barrier, make_mesh, shard_train_state
from byogan_tpu_torch.profiling import annotate
from byogan_tpu_torch.serve import encode_png
from byogan_tpu_torch.train.checkpoint import prune_checkpoints, restore_train_state, save_checkpoint
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.metrics import MetricsLogger
from byogan_tpu_torch.train.state import TrainState, create_train_state
from byogan_tpu_torch.train.steps import make_train_step


def model_spec(config: TrainConfig) -> ModelSpec:
    return ModelSpec(
        num_stages=max(config.num_stages, 1),
        channel_divisor=config.channel_divisor,
        mapping_depth=config.mapping_depth,
    )


def build_state(config: TrainConfig, device: torch.device) -> TrainState:
    """Fresh nets (weights seeded from ``config.seed``) and optimizers."""
    spec = model_spec(config)
    dtype = None if config.compute_dtype == "float32" else getattr(torch, config.compute_dtype)
    init = torch.Generator().manual_seed(config.seed)
    gen = build_generator(spec, dtype=dtype, z_dim=config.noise_size, generator=init)
    critic = build_critic(spec, generator=init)
    return create_train_state(config, gen, critic, device)


def save_sample_grid(
    state: TrainState,
    config: TrainConfig,
    show_z: torch.Tensor,
    steps: int,
    alpha: Optional[float],
    iters: int,
    filename: str,
    write: bool = True,
) -> Optional[str]:
    """The fixed-latent sample grid (train.py:236-245): images clamped to
    [0, 1], sqrt(show_noise_count) per row, as a PNG without the
    reference's matplotlib title.  ``write`` False renders it only (a rank
    that enters a sharded generator's collectives) and returns None."""
    dev = show_z.device
    rng = torch.Generator(device=dev).manual_seed(config.seed * 1_000_003 + 13 + iters)
    dtype = getattr(torch, config.compute_dtype)
    noise = synthesis_noise(rng, show_z.shape[0], steps, dtype=dtype)
    with torch.no_grad():
        img = state.gen(show_z.to(dtype), noise, steps=steps, alpha=alpha).float()
    if not write:
        return None
    grid = make_grid(to_uint8(img.clamp(0.0, 1.0)).cpu().numpy(), nrow=int(np.sqrt(config.show_noise_count)))
    os.makedirs(config.output_dir, exist_ok=True)
    path = os.path.join(config.output_dir, f"{filename}.png")
    with open(path, "wb") as f:
        f.write(encode_png(grid))
    return path


def evict_stage_cache(eval_cache: Dict[tuple, object], steps: int) -> None:
    """Drop the eval cache's entries of stages other than ``steps``: keys
    are ``(what, steps)``, and the real images of a stage are the large
    ones (eval_images f32 frames on the device)."""
    for key in [k for k in eval_cache if k[1] != steps]:
        del eval_cache[key]


def log_eval(
    state: TrainState,
    config: TrainConfig,
    dataset,
    steps: int,
    alpha: Optional[float],
    iters: int,
    eval_cache: Dict[tuple, object],
    logger: MetricsLogger,
) -> Dict[str, float]:
    """The periodic evaluation (byogan_tpu/train/loop.py:561-674): SWD of
    ``eval_images`` fresh samples at the stage's ``alpha`` against a seeded
    subset (without replacement) of the stage's real images, ``swd`` for
    the generator and ``swd_ema`` for its EMA, with the MS-SSIM diversity
    of each sample set (``msssim``, ``msssim_ema``) and of the real subset
    (``msssim_real``, once per stage).  Latents come from the training
    distribution.  The real subset is kept on the device, uploaded as uint8
    and converted there; ``eval_cache`` holds it per stage.  Every draw
    comes from a generator seeded from ``(config.seed, iters)``, the same
    for both nets, and none from the training's.  Logs and returns the
    values."""
    from byogan_tpu_torch.eval.msssim import msssim_diversity
    from byogan_tpu_torch.eval.swd import sliced_wasserstein_distance

    dev = next(state.gen.parameters()).device
    n = min(config.eval_images, len(dataset))
    real_key = ("real", steps)
    if real_key not in eval_cache:
        idx = np.random.default_rng(config.seed + 8191).choice(len(dataset), size=n, replace=False)
        u8 = torch.from_numpy(dataset.get_batch_uint8(np.sort(idx))).to(dev)
        eval_cache[real_key] = uint8_to_training_range(u8)
    real = eval_cache[real_key]
    dtype = getattr(torch, config.compute_dtype)
    tag = config.seed * 1_000_003 + iters
    nets = [("swd", state.gen)] + ([("swd_ema", state.gen_ema)] if state.gen_ema is not None else [])
    values: Dict[str, float] = {}
    for name, net in nets:
        rng = torch.Generator(device=dev).manual_seed(tag + 131071)
        z = truncated_noise(rng, n, config.noise_size, config.noise_trunc, dtype)
        noise = synthesis_noise(rng, n, steps, dtype=dtype)
        with torch.no_grad():
            fake = net(z, noise, steps=steps, alpha=alpha).float()
        swd = sliced_wasserstein_distance(
            real, fake, torch.Generator(device=dev).manual_seed(tag + 524287),
            patches_per_image=64, min_size=min(16, 4 * 2 ** (steps - 1)),
        )
        values[name] = round(swd[0], 3)
        if n >= 2:
            values["msssim" + name[len("swd"):]] = round(float(msssim_diversity(fake)), 4)
    if n >= 2:
        anchor_key = ("msssim_real", steps)
        if anchor_key not in eval_cache:
            eval_cache[anchor_key] = round(float(msssim_diversity(real)), 4)
        values["msssim_real"] = eval_cache[anchor_key]
    logger.log_eval(iters, steps, values)
    return values


@contextlib.contextmanager
def _graceful_stop():
    """SIGTERM or SIGINT -> checkpoint and return at the next iteration
    boundary (byogan_tpu/train/loop.py:89-123).  Yields a list that the
    first signal appends to; a second signal raises KeyboardInterrupt.
    Handlers are installed only on the main thread and always restored."""
    stop_requested: list = []
    if threading.current_thread() is not threading.main_thread():
        yield stop_requested  # signals cannot be bound here
        return

    def request(signum, frame):
        if stop_requested:
            raise KeyboardInterrupt  # second signal: abort now
        stop_requested.append(signum)
        print(
            f"received signal {signum}: saving a checkpoint and exiting at "
            "the next iteration boundary (send again to abort immediately)",
            flush=True,
        )

    prev = {sig: signal.signal(sig, request) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield stop_requested
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def train(
    config: TrainConfig,
    checkpoint: Optional[str] = None,
    max_iters: Optional[int] = None,
    device: Optional[str] = None,
    allow_config_mismatch: bool = False,
) -> TrainState:
    """Run the progressive schedule (reference train.py:15).  ``device``
    defaults to ``cuda`` and raises without a GPU; ``checkpoint`` resumes
    from a ``.pth``, whose trajectory knobs must match ``config``'s unless
    ``allow_config_mismatch`` (then a warning).  SIGTERM and SIGINT save a
    checkpoint and return at the next iteration boundary."""
    with _graceful_stop() as stop_requested:
        return _train(config, checkpoint, max_iters, device, allow_config_mismatch, stop_requested)


def check_data_axis(config: TrainConfig, data: int) -> None:
    """Every stage's batch must split evenly over the data axis
    (byogan_tpu/train/loop.py:181-195): fail now, not at that stage."""
    bad = [(i + 1, b) for i, b in enumerate(config.batch_progression[: config.num_stages]) if b % data != 0]
    if bad:
        raise ValueError(
            f"batch_progression entries {bad} (stage, batch) are not "
            f"divisible by the data-parallel axis ({data}); fix the "
            "config now rather than crashing mid-run at that stage"
        )


def _train(
    config: TrainConfig,
    checkpoint: Optional[str],
    max_iters: Optional[int],
    device: Optional[str],
    allow_config_mismatch: bool,
    stop_requested: list,
) -> TrainState:
    dev = resolve_device(device)
    if config.data is None:
        raise ValueError("config.data must point at a prepared dataset")
    if not os.path.exists(os.path.join(config.data, "prepared")):
        raise OSError("Did not detect prepared dataset!")
    mesh = None
    if config.data_axis > 1 or config.model_axis > 1 or (dist.is_initialized() and dist.get_world_size() > 1):
        check_data_axis(config, config.data_axis)
        mesh = make_mesh(config.data_axis, config.model_axis, device=dev)
        dev = mesh.device
    elif dist.is_initialized():  # a one-process group: the step without a mesh
        print(f"process group: world 1 ({dist.get_backend()}), no mesh")
    primary = mesh is None or mesh.global_rank == 0  # writes
    renders = mesh is None or mesh.rank == 0  # rank 0's model group: grids and eval
    parallel = {} if mesh is None else {"mesh": mesh}  # the step's arguments without a mesh stay as they were
    say = print if primary else (lambda *a, **k: None)
    spec = model_spec(config)
    state = build_state(config, dev)
    alpha_ckpt: Optional[float] = None
    last_stage = None
    if checkpoint is not None:
        alpha_ckpt = restore_train_state(checkpoint, state, config, allow_config_mismatch)
        last_stage = state.stage
    if mesh is not None:
        shard_train_state(state, mesh)
        axes = f"data {mesh.size}" + (f" x model {mesh.model_size}" if mesh.model_size > 1 else "")
        say(f"mesh: {axes} ({mesh.backend})")
    os.makedirs(config.checkpoint_dir, exist_ok=True)

    show_z = truncated_noise(
        torch.Generator().manual_seed(config.seed + 7), config.show_noise_count,
        config.noise_size, config.show_noise_trunc,
    ).to(dev)
    logger = MetricsLogger(os.path.join(config.output_dir, "metrics.jsonl") if primary else None, print_fn=say)
    k = config.refresh_stat_step
    c_hist: collections.deque = collections.deque(maxlen=k)
    g_hist: collections.deque = collections.deque(maxlen=k)
    eval_cache: Dict[tuple, object] = {}

    def stopping() -> bool:
        """Whether a signal asks to stop, agreed by every rank."""
        return bool(stop_requested) if mesh is None else agree(bool(stop_requested), mesh)

    def between_barriers(fn, *args, run: bool = True, **kw):
        """``fn`` on the ranks where ``run`` while the others wait."""
        barrier(mesh)
        out = fn(*args, **kw) if run else None
        barrier(mesh)
        return out

    def save(alpha: Optional[float], name: Optional[str] = None, prune: bool = False) -> str:
        """Every rank gathers (``save_checkpoint`` with the mesh); rank 0 writes."""
        path = save_checkpoint(config.checkpoint_dir, state, alpha, name=name, model_spec=spec,
                               train_config=config, mesh=mesh)
        if prune and primary:
            prune_checkpoints(config.checkpoint_dir, config.max_checkpoints)
        return path

    def stop(epoch: int, preempted: bool) -> TrainState:
        logger.close()
        state.epoch = epoch
        path = between_barriers(save, alpha_ckpt)
        if preempted:
            say(f"preemption checkpoint saved: {path}", flush=True)
        return state

    for index in range(config.num_stages):
        steps = index + 1
        if last_stage is not None and steps < last_stage:
            continue
        evict_stage_cache(eval_cache, steps)
        batch = config.stage_batch(index)
        stage_epochs = config.stage_epochs(index)
        dataset = open_stage_dataset(config.data, steps)
        n_batches = batches_per_epoch(len(dataset), batch)
        if n_batches == 0:
            raise ValueError(f"stage {steps}: dataset ({len(dataset)}) smaller than batch ({batch})")
        fade_in = config.fade_percentage * stage_epochs * n_batches
        resume = last_stage is not None and steps == last_stage
        if not resume:
            state.im_count = 0
        state.stage = steps
        iters_done = state.im_count // (batch * config.critic_repeats)
        resume_epoch = iters_done // n_batches if resume else 0
        resume_skip = iters_done % n_batches if resume else 0
        say(f"STARTING STEP #{steps}")
        step_cache = {}

        for epoch in range(resume_epoch, stage_epochs):
            loader = make_stage_loader(
                dataset, batch, seed=config.seed * 100003 + steps * 1009 + epoch,
                skip_batches=resume_skip if epoch == resume_epoch else 0,
                process_index=0 if mesh is None else mesh.rank,
                process_count=1 if mesh is None else mesh.size, workers=config.num_workers,
            )
            for real in to_device(loader, dev):
                repeats = config.critic_repeats
                critic_fade = tuple(
                    (state.im_count + r * batch) / fade_in <= 1.0 for r in range(repeats)
                )
                gen_fade = (state.im_count + repeats * batch) / fade_in <= 1.0
                key = (critic_fade, gen_fade)
                if key not in step_cache:
                    step_cache[key] = make_train_step(
                        config, steps, batch, fade_in, critic_fade, gen_fade, **parallel
                    )
                with annotate(f"train_step stage {steps}"):
                    metrics = step_cache[key](state, real)
                gen_alpha = state.im_count / fade_in
                alpha_ckpt = None if gen_alpha > 1.0 else gen_alpha

                c_hist.append(metrics["c_loss"])
                g_hist.append(metrics["g_loss"])
                if primary and state.iters % k == 0:
                    # byogan_tpu/train/loop.py:421-441: r_t, then the regularizers' state
                    extra = {
                        name: round(float(metrics[key]), 4)
                        for name, key in (("rt", "real_sign"), ("aug_p", "aug_p"), ("rt_ema", "rt_ema"),
                                          ("pl_ema", "pl_ema"), ("pl_penalty", "pl_penalty"))
                        if key in metrics
                    } or None
                    logger.log_step(
                        state.iters, float(torch.stack(list(c_hist)).mean()),
                        float(torch.stack(list(g_hist)).mean()), epoch, steps, batch, extra,
                    )
                if renders and state.iters % config.display_step == 0:
                    save_sample_grid(
                        state, config, show_z, steps, alpha_ckpt if gen_fade else None,
                        state.iters, f"s-{state.iters}", write=primary,
                    )
                if config.eval_step > 0 and state.iters % config.eval_step == 0:
                    between_barriers(
                        log_eval, state, config, dataset, steps, alpha_ckpt if gen_fade else None,
                        state.iters, eval_cache, logger, run=renders,
                    )
                if state.iters % config.checkpoint_step == 0:
                    state.epoch = epoch
                    between_barriers(save, alpha_ckpt, prune=True)
                preempted = stopping()  # the ranks agree once an iteration, after its step
                if preempted or (max_iters is not None and state.iters >= max_iters):
                    return stop(epoch, preempted)
            state.epoch = epoch
        last_stage = None

    preempted = stopping()
    if renders and not preempted:  # a signal after the last iteration goes straight to the save
        save_sample_grid(state, config, show_z, state.stage, None, state.iters, "s-final", write=primary)
    between_barriers(save, None, name="FINAL")
    logger.close()
    say("TRAINING IS FINISHED - MODEL SAVED!")
    return state
