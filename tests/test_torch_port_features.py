"""The port's EMA, style mixing, W-space truncation and preemption-safe
resume against the JAX package's, on the CPU.

Small models (the conftest tables), f32.  The same numpy inputs go to both
packages; the JAX train step's own draws, mixing draws included, are
replayed into the port's step (``_jax_draws``).  Tolerances are the suite's
own: 2e-4 relative for losses and forwards, parameters after whole steps
within 2e-3 and 99.9% of entries within 1e-5 (``_assert_params``), 1 LSB
on uint8 frames; the EMA update to one f32 ulp.
"""

import dataclasses
import functools
import os
import signal
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.compat.torch_ckpt import critic_state_from_jax, generator_state_from_jax
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.projector import mean_w
from byogan_tpu_torch.serve import Sampler
from byogan_tpu_torch.train import checkpoint as port_ckpt
from byogan_tpu_torch.train import loop as port_loop
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.state import create_train_state
from tests.conftest import build, small_config
from tests.test_torch_port_train import BATCH, _assert_params, _jax_draws, _port_models, _port_state, _t, assert_rel

STEPS, ALPHA = 3, 0.4
SPEC = dict(num_stages=3, channel_divisor=16, style_dim=512, mapping_depth=2)
SPEC_DICT = ModelSpec(**SPEC).to_dict()


# -- style mixing and EMA in the train step ---------------------------------


@pytest.mark.parametrize("steps,mix_prob", [(2, 0.9), (3, 0.5), (5, 1.0)])
def test_mixed_styles_match_jax(steps, mix_prob):
    from byogan_tpu.train.steps import mixed_styles

    r = np.random.default_rng(steps)
    w1, w2 = (r.standard_normal((16, 8)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(steps)
    want = mixed_styles(key, jnp.asarray(w1), jnp.asarray(w2), steps, mix_prob)
    coin_key, t_key = jax.random.split(key)
    coin = _t(jax.random.uniform(coin_key, (16,)))
    t = torch.from_numpy(np.asarray(jax.random.randint(t_key, (16,), 1, steps), np.int64))
    got = port_steps.mixed_styles(_t(w1), _t(w2), coin, t, steps, mix_prob)
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ema_update_matches_jax():
    r = np.random.default_rng(0)
    e, p = (r.standard_normal(1000).astype(np.float32) for _ in range(2))
    beta = 0.999
    want = jax.jit(lambda e, p: e * beta + p.astype(e.dtype) * (1.0 - beta))(e, p)
    ema = [_t(e)]
    port_steps.ema_update(ema, [_t(p)], beta)
    np.testing.assert_array_max_ulp(ema[0].numpy(), np.asarray(want), maxulp=1)


@pytest.fixture(scope="module")
def small_jax():
    return build(small_config())


def _jax_mixed_gen_grads(jstate, new_critic, draws, steps, alpha):
    """jax.grad of the generator phase's loss with mixed styles, the
    crossover drawn from the phase's own key as steps.py:144-157, 274."""
    from byogan_tpu.train import losses as jl
    from byogan_tpu.train.steps import mixed_styles
    from tests.conftest import small_critic, small_generator

    rng = jax.random.split(jstate.rng, 5)[0]
    mix_key = jax.random.split(jax.random.split(rng, 4)[1], 3)[2]
    (z, noise), mix = draws.gen, draws.mix[-1]
    jg, a = small_generator(), None if alpha is None else jnp.float32(alpha)

    def loss(gp):
        w1, w2 = (jg.apply({"params": gp}, jnp.asarray(v.numpy()), method="map_latent") for v in (z, mix.z2))
        img = jg.apply({"params": gp}, None, [jnp.asarray(n.numpy()) for n in noise], steps=steps, alpha=a,
                       style=mixed_styles(mix_key, w1, w2, steps, 0.9))
        return jl.gen_logistic_loss(small_critic().apply({"params": new_critic}, img, steps=steps, alpha=a))

    return generator_state_from_jax(jax.jit(jax.grad(loss))(jstate.gen_params))


@pytest.mark.parametrize("steps,fade", [(2, True), (3, False)])
def test_mixed_style_train_steps_with_ema_match_jax(small_jax, steps, fade):
    """Two steps with mixing and EMA.  At stage 3 the first step's generator
    gradients are held at 2e-4.  Parameters are held after both steps at stage 2 and
    after the first at stage 3: there the second step's Adam update, which
    divides each gradient by its own running scale, spreads the first
    step's few sign flips of near-zero gradients (and f32 rounding) over
    more than 0.1% of entries, on the default path as well (0.5% beyond
    1e-5 without mixing, 8.6% with it) while both phases' gradients agree
    within 3.4e-6 of their max."""
    from byogan_tpu.train.steps import make_train_step
    from byogan_tpu_torch.models.critic import Critic as PortCritic
    from tests.conftest import SMALL_CRITIC_BLOCKS, SMALL_CRITIC_FROM_RGB

    jcfg = small_config(style_mix_prob=0.9, ema_beta=0.99)
    jgen, jcritic, jstate = small_jax
    jstate = jstate.replace(gen_ema=jax.tree.map(lambda x: x.copy(), jstate.gen_params))
    pcfg, pstate = _port_state(jcfg, jstate)
    assert pstate.gen_ema is not None and not any(p.requires_grad for p in pstate.gen_ema.parameters())
    fade_in = 10.0
    jstep = make_train_step(
        jgen, jcritic, jcfg, steps=steps, batch=BATCH, fade_in=fade_in,
        critic_fade=(fade,), gen_fade=fade, donate=False,
    )
    pstep = port_steps.make_train_step(pcfg, steps, BATCH, fade_in, (fade,), fade)
    r = 4 * 2 ** (steps - 1)
    real = np.random.default_rng(steps).integers(0, 256, (BATCH, r, r, 3), dtype=np.uint8)
    for i in range(2):
        draws, _ = _jax_draws(jstate.rng, jcfg, steps)
        assert draws.mix is not None and len(draws.mix) == 2
        new_j, jm = jstep(jstate, jnp.asarray(real))
        if i == 0 and steps == 3:
            alpha_g = BATCH / fade_in if fade else None
            want = _jax_mixed_gen_grads(jstate, new_j.critic_params, draws, steps, alpha_g)
            critic = PortCritic(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS).requires_grad_(False)
            critic.load_state_dict(critic_state_from_jax(new_j.critic_params))
            g_loss = port_steps.generator_loss(
                types.SimpleNamespace(gen=pstate.gen, critic=critic), pcfg, *draws.gen, steps, alpha_g, draws.mix[-1]
            )
            grads = torch.autograd.grad(g_loss, list(pstate.gen.parameters()), allow_unused=True)
            for (n, _), g in zip(pstate.gen.named_parameters(), grads):
                assert_rel(np.zeros(want[n].shape) if g is None else g.numpy(), want[n].numpy(), what=f"gen {n}")
        pm = pstep(pstate, torch.from_numpy(real), draws)
        jstate = new_j
        for k in ("c_loss", "g_loss", "real_pred", "fake_pred", "r1_penalty"):
            assert_rel(float(pm[k]), float(jm[k]), what=f"step {i} {k}")
        if i == 0 or steps == 2:
            _assert_params(pstate.gen.state_dict(), generator_state_from_jax(jstate.gen_params))
            _assert_params(pstate.gen_ema.state_dict(), generator_state_from_jax(jstate.gen_ema))
            _assert_params(pstate.critic.state_dict(), critic_state_from_jax(jstate.critic_params))


def test_step_refuses_draws_that_do_not_match_the_mixing_config():
    cfg = PortConfig(style_mix_prob=0.9, noise_size=16, compute_dtype="float32")
    step = port_steps.make_train_step(cfg, 2, 2, 10.0, (False,), False)
    draws = port_steps.Draws([(torch.zeros(2, 16), [], None)], (torch.zeros(2, 16), []))
    with pytest.raises(ValueError, match="draws.mix"):
        step(None, torch.zeros(2, 8, 8, 3), draws)


# -- the resume guard and the graceful stop ---------------------------------


def test_check_resume_config_matches_jax(capsys):
    from byogan_tpu.train.checkpoint import trajectory_snapshot

    jcfg = small_config(style_mix_prob=0.9, ema_beta=0.99)
    pcfg = PortConfig(**dataclasses.asdict(jcfg))
    saved = port_ckpt.trajectory_snapshot(pcfg)
    assert saved == trajectory_snapshot(jcfg)
    port_ckpt.check_resume_config(saved, pcfg)
    port_ckpt.check_resume_config(None, pcfg)  # no snapshot: unchecked
    changed = dataclasses.replace(pcfg, style_mix_prob=0.5, seed=3)
    with pytest.raises(ValueError, match="style_mix_prob") as err:
        port_ckpt.check_resume_config(saved, changed)
    assert "seed" in str(err.value) and "--force-resume" in str(err.value)
    port_ckpt.check_resume_config(saved, changed, allow_mismatch=True)
    out = capsys.readouterr().out
    assert "WARNING" in out and "style_mix_prob" in out


def test_graceful_stop_handler():
    before = signal.getsignal(signal.SIGTERM)
    with port_loop._graceful_stop() as stop_requested:
        assert stop_requested == []
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop_requested == [signal.SIGTERM]
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is before


def _loop_config(tmp_path, root, **kw):
    return PortConfig(
        data=root, noise_size=16, compute_dtype="float32", batch_progression=(4, 4),
        epoch_progression=(2, 2), channel_divisor=32, mapping_depth=2, display_step=100,
        checkpoint_step=100, refresh_stat_step=2, fade_percentage=0.5, ema_beta=0.9,
        style_mix_prob=0.9, checkpoint_dir=str(tmp_path / "ck"), output_dir=str(tmp_path / "out"), **kw,
    )


def test_sigterm_stop_then_resume_ends_equal_to_the_uninterrupted_run(tmp_path, capsys):
    root = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=2)
    full = port_loop.train(_loop_config(tmp_path / "a", root), device="cpu")
    assert full.iters == 8 and full.gen_ema is not None

    cfg = _loop_config(tmp_path / "b", root)
    make_step = port_loop.make_train_step

    def signalling_step(*args):
        step = make_step(*args)

        def run(state, real, draws=None):
            out = step(state, real, draws)
            if state.iters == 5:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return run

    with mock.patch.object(port_loop, "make_train_step", signalling_step):
        part = port_loop.train(cfg, device="cpu")
    assert part.iters == 5
    assert "preemption checkpoint saved" in capsys.readouterr().out
    ckpt = os.path.join(cfg.checkpoint_dir, "chk-5.pth")
    saved = torch.load(ckpt, weights_only=False)
    assert "gen_ema" in saved and saved["train_config"] == port_ckpt.trajectory_snapshot(cfg)

    changed = dataclasses.replace(cfg, style_mix_prob=0.5)
    with pytest.raises(ValueError, match="style_mix_prob"):
        port_loop.train(changed, checkpoint=ckpt, device="cpu")
    resumed = port_loop.train(cfg, checkpoint=ckpt, device="cpu")
    assert resumed.iters == 8
    for net in ("gen", "critic", "gen_ema"):
        want, got = getattr(full, net).state_dict(), getattr(resumed, net).state_dict()
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=f"{net} {k}")


def test_resume_seeds_the_ema_from_a_checkpoint_without_one(tmp_path):
    spec = ModelSpec(channel_divisor=32, num_stages=2, mapping_depth=2)
    plain = create_train_state(
        PortConfig(noise_size=16), build_generator(spec, z_dim=16, generator=torch.Generator().manual_seed(1)),
        build_critic(spec), torch.device("cpu"),
    )
    path = port_ckpt.save_checkpoint(str(tmp_path), plain, None, model_spec=spec)
    assert "gen_ema" not in torch.load(path, weights_only=False)
    ema_cfg = PortConfig(noise_size=16, ema_beta=0.9)
    state = create_train_state(ema_cfg, build_generator(spec, z_dim=16), build_critic(spec), torch.device("cpu"))
    port_ckpt.restore_train_state(path, state, ema_cfg)
    for k, v in plain.gen.state_dict().items():
        torch.testing.assert_close(state.gen_ema.state_dict()[k], v, atol=0, rtol=0)


# -- checkpoints, mean_w and the sampling surfaces ---------------------------


def test_port_checkpoint_with_ema_renders_the_same_pixels_in_jax(tmp_path):
    from byogan_tpu.compat.torch_ckpt import generator_params_from_torch
    from byogan_tpu.models.factory import ModelSpec as JaxSpec
    from byogan_tpu.models.factory import build_generator as jax_build
    from byogan_tpu.train.checkpoint import load_checkpoint

    spec = ModelSpec(channel_divisor=32)
    cfg = PortConfig(noise_size=16, compute_dtype="float32", ema_beta=0.9, style_mix_prob=0.9)
    gen = build_generator(spec, z_dim=16, generator=torch.Generator().manual_seed(9))
    state = create_train_state(cfg, gen, build_critic(spec), torch.device("cpu"))
    with torch.no_grad():
        for n, p in state.gen_ema.named_parameters():  # an EMA that differs from gen
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(n))))
    state.stage = 3
    path = port_ckpt.save_checkpoint(str(tmp_path), state, 0.25, name="port", model_spec=spec, train_config=cfg)
    saved = torch.load(path, weights_only=False)
    assert saved["train_config"]["style_mix_prob"] == 0.9
    loaded = load_checkpoint(path)
    assert loaded["step"] == 3 and loaded["alpha"] == 0.25 and "critic_params" in loaded
    r = np.random.default_rng(10)
    z = r.uniform(-0.75, 0.75, (2, 16)).astype(np.float32)
    noise = [r.standard_normal((2, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32) for i in range(3)]
    jgen = jax_build(JaxSpec(channel_divisor=32))
    render = jax.jit(lambda p, z, noise: jgen.apply({"params": p}, z, noise, steps=3, alpha=jnp.float32(0.25)))
    for params, net in ((loaded["gen_params"], state.gen),
                        (generator_params_from_torch({k: v.numpy() for k, v in saved["gen_ema"].items()}), state.gen_ema)):
        want = render(params, jnp.asarray(z), [jnp.asarray(n) for n in noise])
        with torch.no_grad():
            got = net(_t(z), [_t(n) for n in noise], steps=3, alpha=0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_mean_w_matches_jax_on_its_latents(small_jax):
    from byogan_tpu.core.random import truncated_noise
    from byogan_tpu.projector import mean_w as jax_mean_w

    jgen, _, jstate = small_jax
    want = jax_mean_w(jgen, {"params": jstate.gen_params}, 32, 0.75)
    z = truncated_noise(jax.random.PRNGKey(0x57AB1E), 4096, 32, 0.75)
    gen, _ = _port_models(jstate)
    got = mean_w(gen, 32, 0.75, z=_t(z))
    assert got.shape == (32,) and got.dtype == torch.float32
    assert_rel(got.numpy(), want, what="mean_w")
    own = mean_w(gen, 32, 0.75)  # the port's own fixed latents: another sample
    assert own.shape == (32,) and torch.equal(own, mean_w(gen, 32, 0.75))


@pytest.fixture(scope="module")
def ema_checkpoint(tmp_path_factory):
    """A small JAX-initialised generator saved as a .pth with a different
    EMA generator; noise weights perturbed so noise shows."""
    from byogan_tpu.compat.torch_ckpt import generator_params_to_torch
    from byogan_tpu.core.random import synthesis_noise as jax_noise
    from byogan_tpu.models.factory import ModelSpec as JaxSpec
    from byogan_tpu.models.factory import build_generator as jax_build

    spec = JaxSpec(**SPEC)
    jgen = jax_build(spec)
    key = jax.random.PRNGKey(4)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jgen.init(k, jnp.zeros((1, 32)), jax_noise(k, 1, STEPS), steps=1))(key)["params"]
    )
    rng = np.random.default_rng(5)
    ema = jax.tree_util.tree_map(lambda v: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32), params)
    for tree in (params, ema):
        for k in range(STEPS):
            for conv in ("conv1", "conv2"):
                w = tree[f"stages_{k}"][conv]["noise"]["weight"]
                tree[f"stages_{k}"][conv]["noise"]["weight"] = (0.3 * rng.standard_normal(w.shape)).astype(np.float32)

    def sd(tree):
        return {k: torch.tensor(v) for k, v in generator_params_to_torch(tree, num_stages=STEPS, mapping_depth=2).items()}

    path = str(tmp_path_factory.mktemp("ckpt") / "ema.pth")
    torch.save({"gen": sd(params), "gen_ema": sd(ema), "step": STEPS, "alpha": ALPHA, "model": spec.to_dict()}, path)
    plain = str(tmp_path_factory.mktemp("ckpt") / "plain.pth")
    torch.save({"gen": sd(params), "step": STEPS, "alpha": ALPHA, "model": spec.to_dict()}, plain)
    return path, plain, jgen, params, ema


def _inputs(seed, n=3):
    r = np.random.default_rng(seed)
    z = np.clip(r.standard_normal((n, 32)), -0.75, 0.75).astype(np.float32)
    noise = [r.standard_normal((n, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32) for i in range(STEPS)]
    return z, noise


@functools.lru_cache(maxsize=None)
def _jax_render(jgen):
    def render(params, noise, styles):
        img = jgen.apply({"params": params}, None, noise, steps=STEPS, alpha=jnp.float32(ALPHA), style=styles)
        return jnp.clip(img.astype(jnp.float32) * 255.0 + 0.5, 0, 255).astype(jnp.uint8)

    return jax.jit(render)


def _jax_frames(jgen, params, noise, styles):
    return np.asarray(_jax_render(jgen)(params, [jnp.asarray(n) for n in noise], styles))


def _jax_w(jgen, params, z, wm, psi):
    w = jax.jit(lambda p, z: jgen.apply({"params": p}, z, method="map_latent"))(params, jnp.asarray(z))
    return w if psi is None else wm + psi * (w - wm)


def _lsb(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@pytest.mark.parametrize("use_ema,psi", [(True, 0.7), (True, None), (False, 0.5)])
def test_sampler_ema_and_psi_match_jax_generator(ema_checkpoint, use_ema, psi):
    path, _, jgen, params, ema = ema_checkpoint
    sampler = Sampler(path, batch=3, dtype="float32", device="cpu", seed=0, use_ema=use_ema, truncation_psi=psi)
    z, noise = _inputs(6)
    got = sampler.render(_t(z), [_t(n) for n in noise]).numpy()
    wm = jnp.asarray(sampler.mean_w().numpy())
    jparams = ema if use_ema else params
    want = _jax_frames(jgen, jparams, noise, _jax_w(jgen, jparams, z, wm, psi))
    assert got.shape == (3, 16, 16, 3) and _lsb(got, want) <= 1


def test_sampler_use_ema_raises_without_ema_weights(ema_checkpoint):
    with pytest.raises(ValueError, match="no EMA weights"):
        Sampler(ema_checkpoint[1], batch=2, device="cpu", use_ema=True)


@pytest.mark.parametrize("crossover", [0, 1, 3])
def test_sampler_style_mix_matches_jax_generator(ema_checkpoint, crossover):
    path, _, jgen, _, ema = ema_checkpoint
    sampler = Sampler(path, batch=3, dtype="float32", device="cpu", seed=0, use_ema=True, truncation_psi=0.7)
    z_a, noise = _inputs(7)
    z_b, _ = _inputs(8)
    got = sampler.render_mix(_t(z_a), _t(z_b), [_t(n) for n in noise], crossover).numpy()
    wm = jnp.asarray(sampler.mean_w().numpy())
    w_a, w_b = _jax_w(jgen, ema, z_a, wm, 0.7), _jax_w(jgen, ema, z_b, wm, 0.7)
    want = _jax_frames(jgen, ema, noise, [w_a if i < crossover else w_b for i in range(STEPS)])
    assert _lsb(got, want) <= 1
    frames = sampler.style_mix(5, crossover)  # a full batch and a ragged one
    assert frames.shape == (5, 16, 16, 3) and frames.dtype == np.uint8
    with pytest.raises(ValueError, match="crossover"):
        sampler.style_mix(2, STEPS + 1)


def test_style_mix_grid_layout_matches_jax(ema_checkpoint, tmp_path):
    """Runs the JAX CLI with a generator that records the styles it is
    given (and renders nothing), then builds the port's layout from the
    same w_a and w_b."""
    from byogan_tpu.cli import style_mix as jax_cli
    from byogan_tpu.models import factory as jax_factory
    from byogan_tpu.train import checkpoint as jax_ckpt
    from byogan_tpu_torch.cli.style_mix import mix_grid_styles

    path, _, _, params, _ = ema_checkpoint
    seen = {"w": [], "styles": None}
    jax_save = {"gen_params": params, "step": STEPS, "alpha": ALPHA, "model": SPEC_DICT}
    real_build = jax_factory.build_generator

    class Recording:
        def __init__(self, gen):
            self.gen = gen

        def apply(self, params, *args, **kw):
            if kw.get("method") == "map_latent":
                out = self.gen.apply(params, *args, **kw)
                jax.debug.callback(lambda w: seen["w"].append(np.asarray(w)), out)
                return out
            style = kw["style"]
            jax.debug.callback(lambda *s: seen.update(styles=[np.asarray(v) for v in s]), *style)
            r = 4 * 2 ** (kw["steps"] - 1)  # the pixels are not under test
            return jnp.zeros((style[0].shape[0], r, r, 3))

    with mock.patch.object(jax_factory, "build_generator", lambda *a, **k: Recording(real_build(*a, **k))), \
            mock.patch.object(jax_ckpt, "load_checkpoint", lambda _: jax_save):
        jax_cli.main([path, "-o", str(tmp_path / "jax.png"), "-r", "2", "-c", "3", "--crossover", "1",
                      "--seed", "2", "-d", "cpu"])
    w_a, w_b = sorted(seen["w"], key=len)  # callbacks come in no fixed order: A has 2 rows, B 3
    got = mix_grid_styles(_t(w_a), _t(w_b), 1, STEPS)
    assert len(got) == len(seen["styles"]) == STEPS
    for g, w in zip(got, seen["styles"]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_style_mix_cli_writes_the_grid(ema_checkpoint, tmp_path, capsys):
    from byogan_tpu_torch.cli.style_mix import main

    from tests.test_torch_port_serve import decode_png

    out = tmp_path / "grid.png"
    main([ema_checkpoint[0], "-o", str(out), "-r", "2", "-c", "3", "--crossover", "1", "--psi", "0.7",
          "--ema", "--seed", "2", "-d", "cpu"])
    grid = decode_png(out.read_bytes())
    assert grid.shape == (3 * 18 + 2, 4 * 18 + 2, 3)  # (rows+1) x (cols+1) cells of 16 px + 2 px padding
    assert "wrote 2x3 mixing grid (crossover 1/3)" in capsys.readouterr().out


def test_generate_samples_cli_takes_ema_and_psi(ema_checkpoint, tmp_path):
    from byogan_tpu_torch.cli.generate_samples import main

    main([ema_checkpoint[0], "3", "-d", "cpu", "-o", str(tmp_path), "--seed", "1", "--ema", "--psi", "0.7"])
    assert sorted(os.listdir(tmp_path)) == [f"image_{i}.png" for i in (1, 2, 3)]
