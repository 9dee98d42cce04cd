"""The port's training path against the JAX package's, on the CPU.

Small models (the conftest tables), f32.  The same numpy inputs go to both
packages; the JAX train step's own random draws are replayed into the
port's step by splitting its key outside the step as steps.py:195-197, 274
do.  The JAX Pallas custom_vjp runs in interpret mode; the port's autograd
Functions run with their plain versions inside, which is the wiring the
card runs with K1, K2 and K3.

Tolerances: 2e-4 for gradients and losses (relative to each tensor's max:
f32 rounding through a few convs, instance norms and a double backward),
as tests/test_pallas_ops.py holds the JAX custom_vjp; 1e-6 for Adam on
identical gradients; parameters after whole steps within 2e-3 = 2*lr (the
most one Adam step moves a parameter, reached where a near-zero gradient
changes sign), and 99.9% of entries within 1e-5.
"""

import dataclasses
import os
import struct
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.compat.torch_ckpt import (
    critic_key_map,
    critic_state_from_jax,
    generator_state_from_jax,
)
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.png import decode_png
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.models.critic import Critic as PortCritic
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.models.generator import Generator as PortGenerator
from byogan_tpu_torch.models.layers import MinibatchStdDev
from byogan_tpu_torch.ops.fused import NoiseLReLUAdaINFunction
from byogan_tpu_torch.ops.styleconv import StyleConvFunction
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.config import load_ini_config as port_load_ini
from byogan_tpu_torch.train.state import create_train_state
from tests.conftest import (
    SMALL_CRITIC_BLOCKS,
    SMALL_CRITIC_FROM_RGB,
    SMALL_GEN_CHANNELS,
    build,
    small_config,
)
from torch_port_inputs import epilogue_inputs, styleconv_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS7 = ("x", "weight", "bias", "noise", "noise_w", "gamma", "beta")
STEPS, BATCH = 2, 4


def assert_rel(got, want, tol=2e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_models(jstate):
    gen = PortGenerator(SMALL_GEN_CHANNELS, style_dim=32, mapping_depth=2, z_dim=32)
    gen.load_state_dict(generator_state_from_jax(jstate.gen_params), strict=True)
    critic = PortCritic(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS)
    critic.load_state_dict(critic_state_from_jax(jstate.critic_params), strict=True)
    return gen, critic


def _port_state(jconfig, jstate):
    pconfig = PortConfig(**dataclasses.asdict(jconfig))
    return pconfig, create_train_state(pconfig, *_port_models(jstate), torch.device("cpu"))


@pytest.fixture(scope="module")
def small_jax():
    """(gen, critic, state) of the small JAX models, built once: the init
    does not depend on the knobs the tests vary."""
    return build(small_config())


# -- the autograd Functions --------------------------------------------------


def _loss_of(out):
    return (out * torch.cos(out)).sum()


@pytest.mark.parametrize("shape", [(4, 8, 8, 16, 24), (2, 16, 16, 8, 8)])
def test_styleconv_function_grads_match_jax_custom_vjp(monkeypatch, shape):
    from byogan_tpu.ops import pallas_styleconv as sc

    monkeypatch.setattr(sc, "_INTERPRET", True)
    ins = styleconv_inputs(*shape, seed=11)
    args = [jnp.asarray(ins[k]) for k in ARGS7]
    want = jax.grad(
        lambda *a: (lambda o: (o * jnp.cos(o)).sum())(sc.styleconv(*a)), argnums=tuple(range(7))
    )(*args)
    targs = [_t(ins[k]).requires_grad_(True) for k in ARGS7]
    got = torch.autograd.grad(_loss_of(StyleConvFunction.apply(*targs, 1e-8)), targs)
    for name, g, w in zip(ARGS7, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert_rel(g.numpy(), w, what=name)


def test_initial_block_function_grads_match_jax_lax():
    from byogan_tpu.ops.fused import noise_lrelu_adain_lax

    names = ("x", "noise", "noise_w", "gamma", "beta")
    ins = epilogue_inputs((3, 4, 4, 16), seed=12)
    want = jax.grad(
        lambda *a: (lambda o: (o * jnp.cos(o)).sum())(noise_lrelu_adain_lax(*a)),
        argnums=tuple(range(5)),
    )(*[jnp.asarray(ins[k]) for k in names])
    targs = [_t(ins[k]).requires_grad_(True) for k in names]
    got = torch.autograd.grad(_loss_of(NoiseLReLUAdaINFunction.apply(*targs, 1e-8)), targs)
    for name, g, w in zip(names, got, want):
        assert_rel(g.numpy(), w, what=name)


def test_functions_refuse_a_second_derivative():
    """Path-length regularization needs a second derivative through the
    Functions, so they take one now (held against plain autograd in
    tests/test_torch_port_regularizers.py); what they refuse is a third."""
    ins = styleconv_inputs(1, 4, 4, 4, 4, seed=13)
    targs = [_t(ins[k]).requires_grad_(True) for k in ARGS7]
    (gx,) = torch.autograd.grad(
        StyleConvFunction.apply(*targs, 1e-8).square().sum(), targs[0], create_graph=True
    )
    (gw,) = torch.autograd.grad(gx.square().sum(), targs[1], create_graph=True)
    assert torch.isfinite(gw).all() and gw.abs().max() > 0
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gw.sum().backward()


# -- the critic ----------------------------------------------------------------


@pytest.fixture(scope="module")
def critic_params():
    from tests.conftest import small_critic

    params = jax.jit(lambda k: small_critic().init(k, jnp.zeros((4, 4, 4, 3)), steps=1))(
        jax.random.PRNGKey(3)
    )["params"]
    r = np.random.default_rng(4)
    # biases start at zero; make them nonzero so their paths show
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * r.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "bias" else np.asarray(v),
        params,
    )


@pytest.mark.parametrize("alpha", [None, 0.3])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_critic_matches_jax(critic_params, steps, alpha):
    from tests.conftest import small_critic

    r = 4 * 2 ** (steps - 1)
    images = np.random.default_rng(steps).standard_normal((6, r, r, 3)).astype(np.float32)
    want = small_critic().apply(
        {"params": critic_params}, jnp.asarray(images), steps=steps,
        alpha=None if alpha is None else jnp.float32(alpha),
    )
    port = PortCritic(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS)
    port.load_state_dict(critic_state_from_jax(critic_params), strict=True)
    with torch.no_grad():
        got = port(_t(images), steps, alpha)
    assert got.shape == (6, 1)
    assert_rel(got.numpy(), want)


@pytest.mark.parametrize("batch", [8, 6])
def test_minibatch_stddev_matches_jax(batch):
    from byogan_tpu.models.layers import MinibatchStdDev as JaxStd

    x = np.random.default_rng(batch).standard_normal((batch, 4, 4, 5)).astype(np.float32)
    want = JaxStd().apply({}, jnp.asarray(x))
    got = MinibatchStdDev()(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_critic_state_keys_are_the_reference_keys(critic_params):
    from byogan_tpu.compat.torch_ckpt import _critic_key_map, critic_params_to_torch

    assert set(build_critic(ModelSpec()).state_dict()) == {k for k, _, _ in _critic_key_map()}
    assert [k for k, _, _ in critic_key_map()] == [k for k, _, _ in _critic_key_map()]
    want = critic_params_to_torch(critic_params, num_stages=3, data_parallel_prefix=False)
    got = critic_state_from_jax(critic_params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# -- losses and critic gradients --------------------------------------------


@pytest.mark.parametrize("use_r1", [True, False])
def test_critic_losses_and_grads_match_jax(critic_params, use_r1):
    from byogan_tpu.train import losses as jl
    from tests.conftest import small_critic

    r = np.random.default_rng(5)
    real = r.standard_normal((4, 8, 8, 3)).astype(np.float32)
    fake = r.standard_normal((4, 8, 8, 3)).astype(np.float32)
    eps_key = jax.random.PRNGKey(6)
    jcritic = small_critic()

    def jloss(cp):
        crit = lambda im: jcritic.apply({"params": cp}, im, steps=2, alpha=jnp.float32(0.4))  # noqa: E731
        if use_r1:
            return jl.critic_r1_loss(crit, jnp.asarray(real), jnp.asarray(fake), 10.0)
        return jl.critic_wgan_gp_loss(crit, jnp.asarray(real), jnp.asarray(fake), 10.0, eps_key)

    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(critic_params)
    port = PortCritic(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS)
    port.load_state_dict(critic_state_from_jax(critic_params), strict=True)
    cfg = PortConfig(use_r1=use_r1, c_lambda=10.0)
    state = types.SimpleNamespace(critic=port, iters=0)
    eps = _t(jax.random.uniform(eps_key, (4, 1, 1, 1)))
    loss, aux = port_steps.critic_loss(state, cfg, _t(real), _t(fake), 2, 0.4, eps)
    assert_rel(loss.item(), float(want_loss), what="loss")
    for k, v in aux.items():
        assert_rel(float(v), float(want_aux[k]), what=k)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    want = critic_state_from_jax(want_grads)
    for n, g in zip(names, grads):
        assert_rel(np.zeros(want[n].shape) if g is None else g.numpy(), want[n].numpy(), what=n)


def test_adam_matches_optax(small_jax):
    import optax

    from byogan_tpu.train.state import make_gen_optimizer

    jcfg = small_config(beta_1=0.5, learning_rate=0.01)
    jstate = small_jax[2]
    pcfg, pstate = _port_state(jcfg, jstate)
    tx, opt_state, params = make_gen_optimizer(jcfg), jstate.gen_opt_state, jstate.gen_params
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    names = [n for n, _ in pstate.gen.named_parameters()]
    r = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(lambda p: r.standard_normal(p.shape).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        tg = generator_state_from_jax(grads)
        for n, p in pstate.gen.named_parameters():
            p.grad.copy_(tg[n])
        pstate.gen_opt.step()
    want = generator_state_from_jax(params)
    got = pstate.gen.state_dict()
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


# -- whole train steps -------------------------------------------------------


def _jax_draws(rng, jconfig, steps):
    """The JAX step's draws from ``rng``, split as steps.py:195-197, 274;
    with style mixing (from stage 2 on), each phase's latent key splits
    into z1, z2 and the coin and crossover keys as steps.py:38-57, 144-154."""
    from byogan_tpu.core.random import synthesis_noise, truncated_noise

    mixing = jconfig.style_mix_prob > 0 and steps >= 2

    def latents(zk):
        return _t(truncated_noise(zk, BATCH, jconfig.noise_size, jconfig.noise_trunc, jnp.float32))

    def zn(zk, nk):
        noise = [_t(n) for n in synthesis_noise(nk, BATCH, steps, dtype=jnp.float32)]
        if not mixing:
            return latents(zk), noise, None
        z1k, z2k, mk = jax.random.split(zk, 3)
        ck, tk = jax.random.split(mk)
        t = torch.from_numpy(np.asarray(jax.random.randint(tk, (BATCH,), 1, steps), np.int64))
        mix = port_steps.Mix(latents(z2k), _t(jax.random.uniform(ck, (BATCH,))), t)
        return latents(z1k), noise, mix

    critic, keys, mixes = [], [], []
    for _ in range(jconfig.critic_repeats):
        rng, zk, nk, ek, _ = jax.random.split(rng, 5)
        z, noise, mix = zn(zk, nk)
        eps = None if jconfig.use_r1 else _t(jax.random.uniform(ek, (BATCH, 1, 1, 1)))
        critic.append((z, noise, eps))
        keys.append(ek)
        mixes.append(mix)
    rng, zk, nk, _ = jax.random.split(rng, 4)
    z, noise, mix = zn(zk, nk)
    return port_steps.Draws(critic, (z, noise), mixes + [mix] if mixing else None), keys


def _assert_params(got, want):
    diffs = []
    for n, w in want.items():
        d = np.abs(got[n].numpy() - w.numpy())
        assert d.max() <= 2e-3, (n, d.max())
        diffs.append(d.ravel())
    d = np.concatenate(diffs)
    assert (d <= 1e-5).mean() >= 0.999, (d <= 1e-5).mean()


@pytest.mark.parametrize(
    "use_r1,fade,n_steps", [(True, True, 1), (True, False, 3), (False, True, 3), (False, False, 1)]
)
def test_train_steps_match_jax(small_jax, use_r1, fade, n_steps):
    from byogan_tpu.models import Generator
    from byogan_tpu.train import losses as jl
    from byogan_tpu.train.steps import make_train_step
    from tests.conftest import small_critic

    jcfg = small_config(use_r1=use_r1)
    jgen, jcritic, jstate = small_jax
    pcfg, pstate = _port_state(jcfg, jstate)
    fade_in = 10.0
    jstep = make_train_step(
        jgen, jcritic, jcfg, steps=STEPS, batch=BATCH, fade_in=fade_in,
        critic_fade=(fade,), gen_fade=fade, donate=False,
    )
    pstep = port_steps.make_train_step(pcfg, STEPS, BATCH, fade_in, (fade,), fade)
    r = np.random.default_rng(8)
    real = r.integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
    real_f = real.astype(np.float32) * (2.0 / 255.0) - 1.0
    for i in range(n_steps):
        draws, eps_keys = _jax_draws(jstate.rng, jcfg, STEPS)
        if i == 0 and n_steps == 1:
            # gradients of both phases at the step's own inputs
            alpha = 0.0 if fade else None
            z, noise, eps = draws.critic[0]
            with torch.no_grad():
                fake = pstate.gen(z, noise, steps=STEPS, alpha=alpha)
            c_loss, _ = port_steps.critic_loss(pstate, pcfg, _t(real_f), fake, STEPS, alpha, eps)
            c_grads = torch.autograd.grad(c_loss, list(pstate.critic.parameters()), allow_unused=True)
            jfake = jnp.asarray(fake.numpy())

            def jc_loss(cp):
                crit = lambda im: jcritic.apply({"params": cp}, im, steps=STEPS, alpha=None if alpha is None else jnp.float32(alpha))  # noqa: E731
                if use_r1:
                    return jl.critic_r1_loss(crit, jnp.asarray(real_f), jfake, jcfg.c_lambda)[0]
                return jl.critic_wgan_gp_loss(crit, jnp.asarray(real_f), jfake, jcfg.c_lambda, eps_keys[0])[0]

            want = critic_state_from_jax(jax.jit(jax.grad(jc_loss))(jstate.critic_params))
            for (n, _), g in zip(pstate.critic.named_parameters(), c_grads):
                assert_rel(np.zeros(want[n].shape) if g is None else g.numpy(), want[n].numpy(), what=f"critic {n}")

        new_j, jm = jstep(jstate, jnp.asarray(real))
        if i == 0 and n_steps == 1:
            alpha_g = BATCH / fade_in if fade else None
            z, noise = draws.gen
            tmp_critic = PortCritic(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS)
            tmp_critic.load_state_dict(critic_state_from_jax(new_j.critic_params))
            tmp_critic.requires_grad_(False)
            g_loss = port_steps.generator_loss(
                types.SimpleNamespace(gen=pstate.gen, critic=tmp_critic), pcfg, z, noise, STEPS, alpha_g
            )
            g_grads = torch.autograd.grad(g_loss, list(pstate.gen.parameters()), allow_unused=True)
            jg = Generator(channels=SMALL_GEN_CHANNELS, style_dim=32, mapping_depth=2)
            a_j = None if alpha_g is None else jnp.float32(alpha_g)

            def jg_loss(gp):
                img = jg.apply({"params": gp}, jnp.asarray(z.numpy()), [jnp.asarray(n.numpy()) for n in noise], steps=STEPS, alpha=a_j)
                pred = small_critic().apply({"params": new_j.critic_params}, img, steps=STEPS, alpha=a_j)
                return jl.gen_logistic_loss(pred) if use_r1 else jl.gen_wgan_loss(pred)

            want = generator_state_from_jax(jax.jit(jax.grad(jg_loss))(jstate.gen_params))
            for (n, _), g in zip(pstate.gen.named_parameters(), g_grads):
                assert_rel(np.zeros(want[n].shape) if g is None else g.numpy(), want[n].numpy(), what=f"gen {n}")

        pm = pstep(pstate, torch.from_numpy(real), draws)
        jstate = new_j
        for k in ("c_loss", "g_loss", "real_pred", "fake_pred", "r1_penalty", "gradient_penalty"):
            if k in jm:
                assert_rel(float(pm[k]), float(jm[k]), what=f"step {i} {k}")
        assert pstate.iters == int(jstate.iters) and pstate.im_count == int(jstate.im_count)
    _assert_params(pstate.gen.state_dict(), generator_state_from_jax(jstate.gen_params))
    _assert_params(pstate.critic.state_dict(), critic_state_from_jax(jstate.critic_params))


# -- config, data, loop, checkpoint, CLI --------------------------------------


def test_config_parity_on_the_example_file():
    from byogan_tpu.train.config import load_ini_config

    path = os.path.join(ROOT, "configs", "example.txt")
    for section in ("ffhq", "anime", "smoke-cpu", "ffhq-tpu-tuned"):  # every section parses, remat included
        want = dataclasses.asdict(load_ini_config(path, section))
        assert dataclasses.asdict(port_load_ini(path, section)) == want, section


def _png(img, filt):
    """An 8-bit PNG of ``img`` (H, W, C in 1..4) with every row under filter
    ``filt`` (0-4), for the decoder's tests."""
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    stride, raw = w * c, b""
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if filt == 0:
            out = line
        elif filt == 1:
            out = line - left
        elif filt == 2:
            out = line - prev
        elif filt == 3:
            out = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            out = line - pred
        raw += bytes([filt]) + (out & 0xFF).astype(np.uint8).tobytes()
        prev = line
    assert len(raw) == h * (stride + 1)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return b"".join((b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(raw)), chunk(b"IEND", b"")))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_matches_jax_decode(tmp_path, channels):
    from PIL import Image

    img = np.random.default_rng(channels).integers(0, 256, (9, 7, channels), dtype=np.uint8)
    for filt in range(5):
        path = tmp_path / f"f{filt}.png"
        path.write_bytes(_png(img, filt))
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(decode_png(path.read_bytes()), want, err_msg=f"filter {filt}")
    # a file written by PIL, with its own choice of filters
    path = tmp_path / "pil.png"
    Image.fromarray(img[..., 0] if channels == 1 else img).save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(decode_png(path.read_bytes()), np.asarray(im.convert("RGB")))


def test_loader_matches_jax_loader(tmp_path):
    from byogan_tpu.data import pipeline as jax_pipe

    root = write_prepared_dataset(str(tmp_path / "data"), 10, 2, seed=1)
    for derived in (False, True):
        if derived:  # stage 2 from set_3's (8 px) files, downsampled
            os.rename(os.path.join(root, "prepared", "set_2"), os.path.join(root, "prepared", "set_3"))
        jds, pds = jax_pipe.open_stage_dataset(root, 2), port_pipe.open_stage_dataset(root, 2)
        assert len(jds) == len(pds) == 10 and pds.derive_shift == int(derived)
        for skip in (0, 1):
            want = list(jax_pipe.make_stage_loader(jds, 4, seed=5, workers=1, skip_batches=skip, device_normalize=True))
            got = list(port_pipe.make_stage_loader(pds, 4, seed=5, skip_batches=skip))
            assert len(got) == len(want) == 2 - skip
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    png_set = port_pipe.StageDataset(root, 3)
    port_pipe.pack_stage(root, 3)
    idx = np.array([3, 0, 7])
    np.testing.assert_array_equal(port_pipe.StageDataset(root, 3).get_batch_uint8(idx),
                                  png_set.get_batch_uint8(idx))


def _loop_config(tmp_path, root, **kw):
    return PortConfig(
        data=root, noise_size=16, compute_dtype="float32", batch_progression=(4, 4),
        epoch_progression=(2, 2), channel_divisor=32, mapping_depth=2, display_step=3,
        checkpoint_step=100, refresh_stat_step=2, fade_percentage=0.5,
        checkpoint_dir=str(tmp_path / "ck"), output_dir=str(tmp_path / "out"), **kw,
    )


def test_loop_resume_continues_the_uninterrupted_run(tmp_path):
    from byogan_tpu_torch.train.loop import train

    root = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=2)
    full = train(_loop_config(tmp_path / "a", root), device="cpu")
    assert full.iters == 8 and full.stage == 2
    assert sorted(os.listdir(tmp_path / "a" / "out")) == ["metrics.jsonl", "s-3.png", "s-6.png", "s-final.png"]
    cfg = _loop_config(tmp_path / "b", root)
    part = train(cfg, max_iters=5, device="cpu")
    assert part.iters == 5
    resumed = train(cfg, checkpoint=os.path.join(cfg.checkpoint_dir, "chk-5.pth"), device="cpu")
    assert resumed.iters == 8
    for net in ("gen", "critic"):
        want, got = getattr(full, net).state_dict(), getattr(resumed, net).state_dict()
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


def test_port_checkpoint_renders_the_same_pixels_in_jax(tmp_path):
    from byogan_tpu.models.factory import ModelSpec as JaxSpec
    from byogan_tpu.models.factory import build_generator as jax_build
    from byogan_tpu.train.checkpoint import load_checkpoint
    from byogan_tpu_torch.train.checkpoint import save_checkpoint

    spec = ModelSpec(channel_divisor=32)
    cfg = PortConfig(noise_size=16, compute_dtype="float32")
    gen = build_generator(spec, z_dim=16, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        for n, p in gen.named_parameters():
            if "inject_noise" in n or n.endswith("conv.bias"):
                p.normal_(0, 0.3, generator=torch.Generator().manual_seed(len(n)))
    state = create_train_state(cfg, gen, build_critic(spec), torch.device("cpu"))
    state.stage = 3
    path = save_checkpoint(str(tmp_path), state, 0.25, name="port", model_spec=spec)
    loaded = load_checkpoint(path)
    assert loaded["step"] == 3 and loaded["alpha"] == 0.25 and "critic_params" in loaded
    r = np.random.default_rng(10)
    z = r.uniform(-0.75, 0.75, (2, 16)).astype(np.float32)
    noise = [r.standard_normal((2, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32) for i in range(3)]
    want = jax_build(JaxSpec(channel_divisor=32)).apply(
        {"params": loaded["gen_params"]}, jnp.asarray(z), [jnp.asarray(n) for n in noise],
        steps=3, alpha=jnp.float32(0.25),
    )
    with torch.no_grad():
        got = gen(_t(z), [_t(n) for n in noise], steps=3, alpha=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_cli_trains_on_the_cpu(tmp_path):
    from byogan_tpu_torch.cli.main import main

    root = write_prepared_dataset(str(tmp_path / "data"), 4, 1, seed=3)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        "[tiny]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 32\n"
        "mapping_depth = 2\nbatch_progression = 4\nepoch_progression = 3\n"
        f"checkpoint_dir = {tmp_path / 'ck'}\noutput_dir = {tmp_path / 'out'}\n"
    )
    state = main(["tiny", "--config-file", str(cfg), "-d", "cpu", "--max-iters", "2"])
    assert state.iters == 2 and os.path.exists(tmp_path / "ck" / "chk-2.pth")
    state = main(["tiny", "--config-file", str(cfg), "-d", "cpu", "-c", str(tmp_path / "ck" / "chk-2.pth")])
    assert state.iters == 3 and os.path.exists(tmp_path / "ck" / "FINAL.pth")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["tiny", "--config-file", str(cfg)])
