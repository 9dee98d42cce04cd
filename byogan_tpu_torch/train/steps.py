"""One training iteration (byogan_tpu/train/steps.py:38-57, 144-157, 168-436).

``critic_repeats`` critic updates on fakes made under ``no_grad``, then one
generator update, as the JAX step does for its default path: per-repeat
fade ``alpha = im_count / fade_in`` with ``im_count += batch`` per repeat,
the generator phase's alpha taken after the repeats, lazy R1 as a host
branch on ``iters``, uint8 batches mapped to [-1, 1] on the device.

On the card the generator's synthesis convs run K1 forward in both phases;
in the generator phase they go through the autograd Functions, whose
backward is K3 and cuDNN's conv transposes.  The critic, the losses and
Adam are plain PyTorch and cuDNN, as JAX leaves them to XLA.

Opt-in extensions of the JAX step: style mixing (``style_mix_prob > 0``,
from stage 2 on: both phases map two latent sets and switch from the first
to the second at a per-sample crossover stage, ``mixed_styles``); the
generator's EMA (``ema_beta > 0``: ``e = e*beta + p*(1-beta)`` after the
generator's Adam step); augmentation of every critic input
(``config.use_aug``: each critic repeat augments its reals and its
detached fakes, R1 is taken at the augmented reals, the generator phase
augments its fakes differentiably, ``ops/augment.py``) with the ADA
controller (``ada_target > 0``: after the generator update, ``rt_ema``
follows the repeats' mean E[sign(D(real))] and ``aug_p`` moves by
``sign(rt_ema - target) * batch * repeats / ada_speed`` within [0, 1],
byogan_tpu/train/steps.py:388-409); and path-length regularization
(``plr_weight > 0``: on iterations where ``iters % plr_interval == 0``, a
host branch as lazy R1's, the generator's loss adds ``plr_weight *
plr_interval`` times the penalty on ``batch // plr_batch_shrink`` latents
of their own, and ``pl_ema`` moves by ``plr_decay * (pl_mean - pl_ema)``,
steps.py:312-369).  With all of them off a step runs the code of the
default path and draws the same random numbers.

Rematerialization (``config.stage_remat(steps - 1)``, byogan_tpu/train/
steps.py:106, 159-163) wraps the applies JAX wraps in ``jax.checkpoint``
in ``torch.utils.checkpoint`` (``maybe_remat``): the critic inside the
critic's loss, R1's double backward included; the generator, plain or
mixed, and the critic in the generator's loss; PLR's synthesis.  Their
activations are not kept for the backward but computed again there, so
on the card the generator phase runs K1 and K2 with residuals twice.

Random draws come from ``state.rng`` in the order of ``draw``.
``step(state, real, draws)`` also takes draws made elsewhere, so a test can
feed it the JAX step's own.

Data and model parallelism (``mesh``, a ``parallel.mesh.Mesh``;
byogan_tpu's jitted step under a sharded state and batch): ``batch`` stays
the global batch and ``real`` is this data rank's row block of it.  Every
rank draws the global iteration's draws from its replica of ``state.rng``
and keeps its data rank's rows (``Draws.rows``), so the model ranks of one
data rank hold bit-equal draws and a run over the mesh follows the
trajectory of one process on the global batch.  After each
``autograd.grad`` (``_update``), at ``model_size > 1``, the replicated
leaves' gradients are made whole over the model group
(``parallel.tensor.reduce_model_grads_``: summed where a rank used the
leaf on its block of channels, averaged where every rank used it whole; a
sharded leaf's gradient is its block's), then every gradient is averaged
over the data group before Adam.  The critic's minibatch-stddev spans the
global batch through the data group; the losses, the critic's aux values,
ADA's E[sign(D(real))] and PLR's mean path length (each rank's share
weighted by its rows) are averaged over the data group in one stacked
all-reduce before the controllers' updates, so ``aug_p``, ``rt_ema`` and
``pl_ema`` stay equal on every rank and the metrics are the global batch's.
Without a mesh the step runs as before.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from byogan_tpu_torch.core.random import stage_resolution, synthesis_noise, truncated_noise
from byogan_tpu_torch.ops.augment import AugDraws, augment_batch, draw_augment
from byogan_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_
from byogan_tpu_torch.parallel.tensor import reduce_model_grads_
from byogan_tpu_torch.train import losses
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import TrainState, set_grads

Noise = List[torch.Tensor]


@dataclasses.dataclass
class Mix:
    """One phase's style-mixing draws: the second latents ``z2``, a
    per-sample coin, uniform in [0, 1), and a crossover stage ``t``,
    uniform in [1, steps)."""

    z2: torch.Tensor
    coin: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass
class PLRDraws:
    """Path-length regularization's draws on a penalized iteration: latents
    ``z`` (batch // plr_batch_shrink of them), their noise maps, and the
    image-space direction ``y``, (N, R, R, 3) standard normal in f32."""

    z: torch.Tensor
    noise: Noise
    y: torch.Tensor


@dataclasses.dataclass
class Draws:
    """Random inputs of one iteration: per critic repeat (z, noise, eps),
    eps None under R1; then the generator phase's (z, noise).  With style
    mixing, ``mix`` holds one ``Mix`` per critic repeat and then the
    generator phase's; ``z`` is then the first latent set.  With
    augmentation, ``aug`` holds per critic repeat the reals' and the fakes'
    ``AugDraws``, then the generator phase's fakes'.  On a penalized
    iteration of path-length regularization, ``plr`` holds its draws."""

    critic: List[Tuple[torch.Tensor, Noise, Optional[torch.Tensor]]]
    gen: Tuple[torch.Tensor, Noise]
    mix: Optional[List[Mix]] = None
    aug: Optional[List[AugDraws]] = None
    plr: Optional[PLRDraws] = None

    @property
    def batch(self) -> int:
        return self.gen[0].shape[0]

    def rows(self, lo: int, hi: int) -> "Draws":
        """The draws of rows ``[lo, hi)`` of the batch: every per-sample
        draw cut to them; PLR's ``batch // plr_batch_shrink`` rows cut in
        proportion, ``[lo*n // batch, hi*n // batch)``."""
        def cut(t):
            return t[lo:hi]

        def cut_all(fields):
            return type(fields)(*(cut(getattr(fields, f.name)) for f in dataclasses.fields(fields)))

        plr = None
        if self.plr is not None:
            n = self.plr.z.shape[0]
            plo, phi = lo * n // self.batch, hi * n // self.batch
            plr = PLRDraws(self.plr.z[plo:phi], [x[plo:phi] for x in self.plr.noise], self.plr.y[plo:phi])
        return Draws(
            [(cut(z), [cut(x) for x in noise], None if eps is None else cut(eps)) for z, noise, eps in self.critic],
            (cut(self.gen[0]), [cut(x) for x in self.gen[1]]),
            None if self.mix is None else [cut_all(m) for m in self.mix],
            None if self.aug is None else [cut_all(a) for a in self.aug],
            plr,
        )


def mixes(config: TrainConfig, steps: int) -> bool:
    """Whether a stage's step mixes styles: stage 1 has no crossover."""
    return config.style_mix_prob > 0 and steps >= 2


def penalized(config: TrainConfig, state: TrainState) -> bool:
    """Whether ``state``'s next iteration adds the path-length penalty
    (``state.iters`` is read only with the penalty on)."""
    return config.plr_weight > 0 and state.iters % config.plr_interval == 0


def draw(
    state: TrainState, config: TrainConfig, batch: int, steps: int, dtype: torch.dtype
) -> Draws:
    """One iteration's draws from ``state.rng``, in this order: per critic
    repeat z, the noise maps, eps (WGAN-GP only), then with mixing z2, the
    coin and t, then with augmentation the reals' and the fakes'
    ``AugDraws``; then the generator phase's z, noise maps and, with
    mixing, z2, coin and t, and with augmentation its ``AugDraws``; then on
    a penalized iteration the ``PLRDraws`` (z, noise maps, y)."""
    rng = state.rng
    mixing = mixes(config, steps)
    res = stage_resolution(steps - 1)

    def latents():
        return truncated_noise(rng, batch, config.noise_size, config.noise_trunc, dtype)

    def z_noise():
        return latents(), synthesis_noise(rng, batch, steps, dtype=dtype)

    def mix_draw():
        z2 = latents()
        coin = torch.rand((batch,), generator=rng, device=rng.device)
        return Mix(z2, coin, torch.randint(1, steps, (batch,), generator=rng, device=rng.device))

    def aug_draw():
        return draw_augment(rng, batch, res, res)

    critic, mix, aug = [], [], []
    for _ in range(config.critic_repeats):
        z, noise = z_noise()
        eps = None
        if not config.use_r1:
            eps = torch.rand((batch, 1, 1, 1), generator=rng, device=rng.device).to(dtype)
        critic.append((z, noise, eps))
        if mixing:
            mix.append(mix_draw())
        if config.use_aug:
            aug += [aug_draw(), aug_draw()]
    gen = z_noise()
    if mixing:
        mix.append(mix_draw())
    if config.use_aug:
        aug.append(aug_draw())
    plr = None
    if penalized(config, state):
        n = max(1, batch // config.plr_batch_shrink)
        z = truncated_noise(rng, n, config.noise_size, config.noise_trunc, dtype)
        noise = synthesis_noise(rng, n, steps, dtype=dtype)
        plr = PLRDraws(z, noise, torch.randn((n, res, res, 3), generator=rng, device=rng.device))
    return Draws(critic, gen, mix if mixing else None, aug if config.use_aug else None, plr)


def mixed_styles(
    w1: torch.Tensor, w2: torch.Tensor, coin: torch.Tensor, t: torch.Tensor,
    steps: int, mix_prob: float,
) -> List[torch.Tensor]:
    """Per-sample crossover (byogan_tpu/train/steps.py:38-57): a sample
    whose coin is below ``mix_prob`` takes ``w2`` from stage ``t`` on, the
    others take ``w1`` at every stage.  Returns ``steps`` per-stage
    (B, style_dim) styles."""
    t = torch.where(coin < mix_prob, t, steps)
    return [torch.where((i >= t)[:, None], w2, w1) for i in range(steps)]


def synthesize(
    gen, config: TrainConfig, z: torch.Tensor, noise: Noise, steps: int,
    alpha: Optional[float], mix: Optional[Mix] = None,
) -> torch.Tensor:
    """Fakes from ``z``; with ``mix``, from two mapping passes mixed per
    stage (byogan_tpu/train/steps.py:144-157: two passes, not one over both
    latent sets, so the rounding is the same)."""
    if mix is None:
        return gen(z, noise, steps=steps, alpha=alpha)
    w1, w2 = gen.map_latent(z), gen.map_latent(mix.z2)
    styles = mixed_styles(w1, w2, mix.coin, mix.t, steps, config.style_mix_prob)
    return gen(None, noise, steps=steps, alpha=alpha, style=styles)


def maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` whose activations are recomputed in the backward instead of
    kept (byogan_tpu/train/steps.py:159-163), or ``fn`` itself.  The
    non-reentrant checkpoint, because the reentrant one cannot be taken
    through ``torch.autograd.grad``, which R1 and PLR take with
    ``create_graph``.  The RNG state is not saved and restored around the
    recompute: nothing inside the wrapped applies draws (every draw of a
    step is made by ``draw`` before it, and augmentation runs outside them
    on its ``AugDraws``), so the recompute sees the same inputs."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], beta: float) -> None:
    """``e = e*beta + p*(1-beta)`` in place, rounded as the JAX expression
    (byogan_tpu/train/steps.py:378-386): each product, then the sum."""
    with torch.no_grad():
        torch._foreach_mul_(ema, beta)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - beta))


def critic_loss(
    state: TrainState,
    config: TrainConfig,
    real: torch.Tensor,
    fake: torch.Tensor,
    steps: int,
    alpha: Optional[float],
    eps: Optional[torch.Tensor],
    remat: bool = False,
) -> Tuple[torch.Tensor, losses.Aux]:
    """The critic phase's loss: R1 (lazy when ``r1_interval > 1``, lambda
    scaled by the interval) or WGAN-GP; ``remat`` recomputes the critic's
    activations in the backward."""
    crit = maybe_remat(lambda imgs: state.critic(imgs, steps, alpha), remat)
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
    mix: Optional[Mix] = None,
    aug: Optional[AugDraws] = None,
    remat: bool = False,
) -> torch.Tensor:
    """The generator phase's loss through the critic; with ``aug`` the
    fakes are augmented (differentiably) at ``state.aug_p`` first.
    ``remat`` recomputes the generator's and the critic's activations in
    the backward, each apply on its own as in JAX."""
    fake = maybe_remat(lambda z_: synthesize(state.gen, config, z_, noise, steps, alpha, mix), remat)(z)
    if aug is not None:
        fake = augment_batch(fake, state.aug_p, aug)
    pred = maybe_remat(lambda imgs: state.critic(imgs, steps, alpha), remat)(fake)
    return losses.gen_logistic_loss(pred) if config.use_r1 else losses.gen_wgan_loss(pred)


def path_length_penalty(
    state: TrainState, plr: PLRDraws, steps: int, alpha: Optional[float], remat: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(penalty, mean path length) on ``plr``'s latents: w from the mapping
    network inside the penalized branch, so the parameter gradient reaches
    the mapping network through w too, and one w for every stage
    (byogan_tpu/train/steps.py:318-336); ``remat`` recomputes the
    synthesis's activations in both backwards."""
    w = state.gen.map_latent(plr.z)
    synth = maybe_remat(lambda w_: state.gen(None, plr.noise, steps=steps, alpha=alpha, style=[w_] * steps), remat)
    return losses.gen_path_length_penalty(synth, w, state.pl_ema, plr.y)


def _update(loss: torch.Tensor, net: torch.nn.Module, opt, mesh: Optional[Mesh] = None) -> None:
    """Adam on the gradients of ``loss`` for ``net``'s parameters; with a
    mesh, on their mean over the data group (JAX's psum over the data axis,
    one flattened all-reduce), the replicated leaves' made whole over the
    model group first."""
    params = list(net.parameters())
    set_grads(params, torch.autograd.grad(loss, params, allow_unused=True))
    if mesh is not None:
        if mesh.model_size > 1:
            reduce_model_grads_(net, mesh)
        all_reduce_mean_([p.grad for p in params], mesh)
    opt.step()


def make_train_step(
    config: TrainConfig,
    steps: int,
    batch: int,
    fade_in: float,
    critic_fade: Tuple[bool, ...],
    gen_fade: bool,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The step of one stage and fade pattern.  ``critic_fade`` has one flag
    per critic repeat (True: the blend path), ``gen_fade`` is the generator
    phase's.  ``fade_in`` is the fade span in images (train.py:119).  The
    stage's remat flag is ``config.stage_remat(steps - 1)``.  With ``mesh``
    the step runs over it (module docstring): ``batch`` is the global
    batch, ``real`` and the critic hold this data rank's share of it."""
    if len(critic_fade) != config.critic_repeats:
        raise ValueError("critic_fade must have one flag per critic repeat")
    dtype = getattr(torch, config.compute_dtype)
    remat = config.stage_remat(steps - 1)

    def step(
        state: TrainState, real: torch.Tensor, draws: Optional[Draws] = None
    ) -> Dict[str, torch.Tensor]:
        """Advance ``state`` by one iteration in place; returns the metrics
        as device scalars (no host sync).  With a mesh, ``draws`` are the
        global batch's."""
        if real.dtype == torch.uint8:
            real = real.float() * (2.0 / 255.0) - 1.0
        real = real.to(dtype)
        if draws is None:
            draws = draw(state, config, batch, steps, dtype)
        plr_share = 1.0
        if mesh is not None:
            lo, hi = mesh.rows(batch)
            if real.shape[0] != hi - lo or draws.batch != batch:
                raise ValueError(
                    f"rank {mesh.rank} takes rows {lo}:{hi} of the global batch {batch}: got {real.shape[0]} "
                    f"real rows and draws for {draws.batch}"
                )
            n_plr = draws.plr.z.shape[0] if draws.plr is not None else 0
            draws = draws.rows(lo, hi)
            if draws.plr is not None:
                if draws.plr.z.shape[0] == 0:
                    raise ValueError(f"PLR's {n_plr} latents leave rank {mesh.rank} none: raise the batch")
                # this rank's mean, weighted by its share of the rows: the ranks' mean is the global mean
                plr_share = draws.plr.z.shape[0] * mesh.size / n_plr
        if (draws.mix is not None) != mixes(config, steps):
            raise ValueError(f"draws.mix must be given exactly when stage {steps} mixes styles")
        if (draws.aug is not None) != config.use_aug:
            raise ValueError("draws.aug must be given exactly when augmentation is on")
        plr_on = penalized(config, state)
        if (draws.plr is not None) != plr_on:
            raise ValueError(f"draws.plr must be given exactly on a penalized iteration (iters {state.iters})")
        for name, on in (("aug_p", config.use_aug), ("rt_ema", config.ada_target > 0),
                         ("pl_ema", config.plr_weight > 0)):
            if on and getattr(state, name) is None:
                raise ValueError(f"TrainState carries no {name}: create the state with the same config")
        im_count = state.im_count
        mix = draws.mix or [None] * (len(critic_fade) + 1)
        aug = draws.aug or [None] * (2 * len(critic_fade) + 1)
        rt_acc = 0.0
        for r, (fade, (z, noise, eps), m) in enumerate(zip(critic_fade, draws.critic, mix)):
            alpha = im_count / fade_in if fade else None
            with torch.no_grad():
                fake = synthesize(state.gen, config, z, noise, steps, alpha, m)
            real_r = real
            if config.use_aug:  # fresh draws for each use; R1 at the augmented reals
                real_r = augment_batch(real, state.aug_p, aug[2 * r])
                fake = augment_batch(fake, state.aug_p, aug[2 * r + 1])
            c_loss, c_aux = critic_loss(state, config, real_r, fake, steps, alpha, eps, remat)
            if config.ada_target > 0:
                rt_acc = rt_acc + c_aux["real_sign"]
            _update(c_loss, state.critic, state.critic_opt, mesh)
            im_count += batch

        z, noise = draws.gen
        alpha_g = im_count / fade_in if gen_fade else None
        state.critic.requires_grad_(False)
        try:
            g_loss = generator_loss(state, config, z, noise, steps, alpha_g, mix[-1], aug[-1], remat)
            if config.plr_weight > 0:
                g_loss, pen = g_loss.float(), torch.zeros((), device=real.device)
                if plr_on:
                    pen, pl_mean = path_length_penalty(state, draws.plr, steps, alpha_g, remat)
                    if plr_share != 1.0:
                        pen, pl_mean = pen * plr_share, pl_mean * plr_share
                    g_loss = g_loss + (config.plr_weight * config.plr_interval) * pen
            _update(g_loss, state.gen, state.gen_opt, mesh)
        finally:
            state.critic.requires_grad_(True)
        if config.ema_beta > 0 and state.gen_ema is not None:
            ema_update(list(state.gen_ema.parameters()), list(state.gen.parameters()), config.ema_beta)
        metrics = {"c_loss": c_loss.detach().float(), "g_loss": g_loss.detach().float(), **c_aux}
        if config.ada_target > 0:
            metrics["real_sign_mean"] = rt_acc / len(critic_fade)
        if plr_on:
            metrics["pl_mean"] = pl_mean.detach()
        if config.plr_weight > 0:
            metrics["pl_penalty"] = pen.detach().float()
        if mesh is not None:  # one all-reduce: the global batch's values on every rank
            values = torch.stack(list(metrics.values()))
            all_reduce_mean_([values], mesh)
            metrics = dict(zip(metrics, values))
        rt_mean = metrics.pop("real_sign_mean", None)
        pl_mean = metrics.pop("pl_mean", None)
        if plr_on:  # pl_ema tracks the path length where it was observed
            state.pl_ema = state.pl_ema + config.plr_decay * (pl_mean - state.pl_ema)
        if config.ada_target > 0:
            beta = config.ada_rt_beta
            state.rt_ema = beta * state.rt_ema + (1.0 - beta) * rt_mean
            step_p = (batch * config.critic_repeats) / float(config.ada_speed)
            state.aug_p = (state.aug_p + torch.sign(state.rt_ema - config.ada_target) * step_p).clamp(0.0, 1.0)
        if config.use_aug:
            metrics["aug_p"] = state.aug_p
        if config.ada_target > 0:
            metrics["rt_ema"] = state.rt_ema
        if config.plr_weight > 0:
            metrics["pl_ema"] = state.pl_ema
        state.iters += 1
        state.im_count = im_count
        return metrics

    return step
