"""One training iteration (byogan_tpu/train/steps.py:168-310, 411-436).

``critic_repeats`` critic updates on fakes made under ``no_grad``, then one
generator update, as the JAX step does for its default path: per-repeat
fade ``alpha = im_count / fade_in`` with ``im_count += batch`` per repeat,
the generator phase's alpha taken after the repeats, lazy R1 as a host
branch on ``iters``, uint8 batches mapped to [-1, 1] on the device.

On the card the generator's synthesis convs run K1 forward in both phases;
in the generator phase they go through the autograd Functions, whose
backward is K3 and cuDNN's conv transposes.  The critic, the losses and
Adam are plain PyTorch and cuDNN, as JAX leaves them to XLA.

Random draws (z, noise maps, WGAN-GP eps) come from ``state.rng`` in the
order of ``draw``.  ``step(state, real, draws)`` also takes draws made
elsewhere, so a test can feed it the JAX step's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.train import losses
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import TrainState, set_grads

Noise = List[torch.Tensor]


@dataclasses.dataclass
class Draws:
    """Random inputs of one iteration: per critic repeat (z, noise, eps),
    eps None under R1; then the generator phase's (z, noise)."""

    critic: List[Tuple[torch.Tensor, Noise, Optional[torch.Tensor]]]
    gen: Tuple[torch.Tensor, Noise]


def draw(
    state: TrainState, config: TrainConfig, batch: int, steps: int, dtype: torch.dtype
) -> Draws:
    rng = state.rng

    def z_noise():
        z = truncated_noise(rng, batch, config.noise_size, config.noise_trunc, dtype)
        return z, synthesis_noise(rng, batch, steps, dtype=dtype)

    critic = []
    for _ in range(config.critic_repeats):
        z, noise = z_noise()
        eps = None
        if not config.use_r1:
            eps = torch.rand((batch, 1, 1, 1), generator=rng, device=rng.device).to(dtype)
        critic.append((z, noise, eps))
    return Draws(critic, z_noise())


def critic_loss(
    state: TrainState,
    config: TrainConfig,
    real: torch.Tensor,
    fake: torch.Tensor,
    steps: int,
    alpha: Optional[float],
    eps: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, losses.Aux]:
    """The critic phase's loss: R1 (lazy when ``r1_interval > 1``, lambda
    scaled by the interval) or WGAN-GP."""
    crit = lambda imgs: state.critic(imgs, steps, alpha)  # noqa: E731
    if not config.use_r1:
        return losses.critic_wgan_gp_loss(crit, real, fake, config.c_lambda, eps)
    if state.iters % config.r1_interval:
        return losses.critic_logistic_loss(crit, real, fake)
    return losses.critic_r1_loss(crit, real, fake, config.c_lambda * config.r1_interval)


def generator_loss(
    state: TrainState,
    config: TrainConfig,
    z: torch.Tensor,
    noise: Noise,
    steps: int,
    alpha: Optional[float],
) -> torch.Tensor:
    """The generator phase's loss through the critic."""
    pred = state.critic(state.gen(z, noise, steps=steps, alpha=alpha), steps, alpha)
    return losses.gen_logistic_loss(pred) if config.use_r1 else losses.gen_wgan_loss(pred)


def _update(loss: torch.Tensor, params: Sequence[torch.nn.Parameter], opt) -> None:
    set_grads(params, torch.autograd.grad(loss, params, allow_unused=True))
    opt.step()


def make_train_step(
    config: TrainConfig,
    steps: int,
    batch: int,
    fade_in: float,
    critic_fade: Tuple[bool, ...],
    gen_fade: bool,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The step of one stage and fade pattern.  ``critic_fade`` has one flag
    per critic repeat (True: the blend path), ``gen_fade`` is the generator
    phase's.  ``fade_in`` is the fade span in images (train.py:119)."""
    if len(critic_fade) != config.critic_repeats:
        raise ValueError("critic_fade must have one flag per critic repeat")
    dtype = getattr(torch, config.compute_dtype)

    def step(
        state: TrainState, real: torch.Tensor, draws: Optional[Draws] = None
    ) -> Dict[str, torch.Tensor]:
        """Advance ``state`` by one iteration in place; returns the metrics
        as device scalars (no host sync)."""
        if real.dtype == torch.uint8:
            real = real.float() * (2.0 / 255.0) - 1.0
        real = real.to(dtype)
        if draws is None:
            draws = draw(state, config, batch, steps, dtype)
        c_params = list(state.critic.parameters())
        g_params = list(state.gen.parameters())
        im_count = state.im_count
        for fade, (z, noise, eps) in zip(critic_fade, draws.critic):
            alpha = im_count / fade_in if fade else None
            with torch.no_grad():
                fake = state.gen(z, noise, steps=steps, alpha=alpha)
            c_loss, c_aux = critic_loss(state, config, real, fake, steps, alpha, eps)
            _update(c_loss, c_params, state.critic_opt)
            im_count += batch

        z, noise = draws.gen
        alpha_g = im_count / fade_in if gen_fade else None
        state.critic.requires_grad_(False)
        try:
            g_loss = generator_loss(state, config, z, noise, steps, alpha_g)
            _update(g_loss, g_params, state.gen_opt)
        finally:
            state.critic.requires_grad_(True)
        state.iters += 1
        state.im_count = im_count
        return {"c_loss": c_loss.detach().float(), "g_loss": g_loss.detach().float(), **c_aux}

    return step
