"""Training state and optimizers (byogan_tpu/train/state.py).

Adam with betas (beta_1, beta_2) and eps 1e-8 for both nets; the
generator's mapping network (``to_w_noise``) is a parameter group at
``mapping_lr_mult`` times the learning rate (reference train.py:59-77).

optax's Adam advances one step count for the whole tree and updates every
parameter, a zero gradient included; ``torch.optim.Adam`` keeps a count per
parameter and skips a parameter whose ``grad`` is None.  So every parameter
holds a gradient from the start (zeros), and ``set_grads`` writes zeros for
the ones a stage does not reach: the stages not yet grown get the same
bias correction as in JAX when they join.

With ``ema_beta > 0`` the state also holds ``gen_ema``, the generator's
exponential moving average (byogan_tpu/train/state.py:38-41, 117-119): a
second ``Generator`` of the same spec, float32 weights, never trained
against (no gradients).

The regularizers' scalars are 0-dim f32 tensors on the device, None when
their feature is off (byogan_tpu/train/state.py:42-53, 131-133): ``aug_p``
(augmentation on) starts at ``config.aug_p``, ``rt_ema`` (ADA) and
``pl_ema`` (path-length regularization) at 0.  The step updates them on
the device, so reading its metrics needs no host sync.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional, Sequence

import torch

from byogan_tpu_torch.core.device import make_generator
from byogan_tpu_torch.models.critic import Critic
from byogan_tpu_torch.models.generator import Generator
from byogan_tpu_torch.train.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    gen: Generator
    critic: Critic
    gen_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    rng: torch.Generator  # z, noise and WGAN-GP eps draws, on the device
    iters: int = 0
    im_count: int = 0  # images seen this stage (train.py:108)
    stage: int = 1
    epoch: int = 0
    gen_ema: Optional[Generator] = None  # EMA shadow of gen (ema_beta > 0)
    aug_p: Optional[torch.Tensor] = None  # augmentation probability (config.use_aug)
    rt_ema: Optional[torch.Tensor] = None  # ADA's smoothed r_t (ada_target > 0)
    pl_ema: Optional[torch.Tensor] = None  # PLR's running path length (plr_weight > 0)


def _adam(groups, config: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(
        groups, lr=config.learning_rate, betas=(config.beta_1, config.beta_2), eps=1e-8
    )


def make_gen_optimizer(gen: Generator, config: TrainConfig) -> torch.optim.Adam:
    """Adam with a ``mapping_lr_mult`` group for the mapping net (train.py:59-70)."""
    mapping = list(gen.to_w_noise.parameters())
    ids = {id(p) for p in mapping}
    main = [p for p in gen.parameters() if id(p) not in ids]
    return _adam(
        [
            {"params": mapping, "lr": config.learning_rate * config.mapping_lr_mult},
            {"params": main},
        ],
        config,
    )


def make_critic_optimizer(critic: Critic, config: TrainConfig) -> torch.optim.Adam:
    """Plain Adam (train.py:76-77)."""
    return _adam(critic.parameters(), config)


def set_grads(
    params: Sequence[torch.nn.Parameter], grads: Iterable[Optional[torch.Tensor]]
) -> None:
    """Store ``grads`` as the parameters' gradients, zeros where None."""
    for p, g in zip(params, grads):
        if g is None:
            p.grad.zero_()
        else:
            p.grad.copy_(g)


def create_train_state(
    config: TrainConfig, gen: Generator, critic: Critic, device: torch.device
) -> TrainState:
    """Move the nets to ``device``, give every parameter a zero gradient and
    build both optimizers; the RNG is seeded from ``config.seed``.  With
    ``ema_beta > 0`` the EMA generator starts as a copy of ``gen``; the
    regularizers' scalars start as the module docstring says."""
    gen_ema = None
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    for net in (gen, critic):
        net.to(device).train()
    if config.ema_beta > 0:
        gen_ema = copy.deepcopy(gen).requires_grad_(False)
    for net in (gen, critic):
        for p in net.parameters():
            p.grad = torch.zeros_like(p)
    return TrainState(
        gen=gen,
        critic=critic,
        gen_opt=make_gen_optimizer(gen, config),
        critic_opt=make_critic_optimizer(critic, config),
        rng=make_generator(device, config.seed),
        gen_ema=gen_ema,
        aug_p=scalar(config.aug_p) if config.use_aug else None,
        rt_ema=scalar(0.0) if config.ada_target > 0 else None,
        pl_ema=scalar(0.0) if config.plr_weight > 0 else None,
    )
