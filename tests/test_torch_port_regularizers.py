"""The port's augmentation, ADA controller, path-length regularization and
the synthesis Functions' second derivative against the JAX package's, on
the CPU.

Small models (the conftest tables), f32.  The same numpy inputs go to both
packages; JAX's own draws are replayed into the port: ``augment_batch``'s
13 key splits as ``AugDraws``, and the train step's augmentation and
path-length keys (steps.py:195-197, 274, 315) as ``Draws.aug`` and
``Draws.plr``.  JAX runs its lax path.  Tolerances: 1e-6 absolute for the
augmentation (elementwise f32); 1e-5 relative on the analytic linear map;
2e-4 relative to each tensor's max for penalties, second derivatives and
gradients, as tests/test_pallas_ops.py holds the custom_vjp; whole steps
as tests/test_torch_port_train.py holds them.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.compat.torch_ckpt import critic_state_from_jax, generator_state_from_jax
from byogan_tpu_torch.core.random import synthesis_noise as port_noise
from byogan_tpu_torch.core.random import truncated_noise as port_latents
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.ops.augment import AugDraws, augment_batch
from byogan_tpu_torch.ops.cardcheck import second_derivatives
from byogan_tpu_torch.ops.fused import NoiseLReLUAdaINFunction, noise_lrelu_adain_plain
from byogan_tpu_torch.ops.styleconv import StyleConvFunction, styleconv_plain
from byogan_tpu_torch.train import losses as port_losses
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.checkpoint import restore_train_state, save_checkpoint
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.loop import build_state
from tests.conftest import build, small_config
from tests.test_torch_port_train import (
    BATCH,
    STEPS,
    _assert_params,
    _jax_draws,
    _port_models,
    _port_state,
    _t,
    assert_rel,
)
from torch_port_inputs import as_torch, epilogue_inputs, styleconv_inputs


@pytest.fixture(scope="module")
def small_jax():
    return build(small_config())


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _aug_draws(key, n, h, w):
    """``byogan_tpu.ops.augment.augment_batch``'s draws from ``key``, split
    as augment.py:67-68 and drawn with its shapes."""
    (k_flip, k_tg, k_ty, k_tx, k_bg, k_b, k_cg, k_c, k_sg, k_s, k_og, k_oy, k_ox) = jax.random.split(key, 13)
    pad = max(h // 8, 1)

    def uniform(k):
        return _t(jax.random.uniform(k, (n,)))

    def normal(k):
        return _t(jax.random.normal(k, (n, 1, 1, 1))).reshape(n)

    return AugDraws(
        uniform(k_flip), uniform(k_tg), _i64(jax.random.randint(k_ty, (n,), -pad, pad + 1)),
        _i64(jax.random.randint(k_tx, (n,), -pad, pad + 1)), uniform(k_bg), normal(k_b), uniform(k_cg),
        normal(k_c), uniform(k_sg), normal(k_s), uniform(k_og), _i64(jax.random.randint(k_oy, (n,), 0, h)),
        _i64(jax.random.randint(k_ox, (n,), 0, w)),
    )


# -- augmentation --------------------------------------------------------------


@pytest.mark.parametrize("size", [4, 16])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_augment_batch_matches_jax(size, p):
    from byogan_tpu.ops.augment import augment_batch as jax_augment

    r = np.random.default_rng(size)
    imgs = r.uniform(-1, 1, (6, size, size, 3)).astype(np.float32)
    cot = r.standard_normal(imgs.shape).astype(np.float32)
    key = jax.random.PRNGKey(int(10 * p) + size)
    want, vjp = jax.vjp(lambda im: jax_augment(key, im, p), jnp.asarray(imgs))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = _t(imgs).requires_grad_(True)
    got = augment_batch(x, p, _aug_draws(key, 6, size, size))
    (grad,) = torch.autograd.grad(got, x, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=0)
    if p == 0.0:
        np.testing.assert_allclose(got.detach().numpy(), imgs, atol=1e-6, rtol=0)
    if p == 1.0:
        assert np.abs(got.detach().numpy() - imgs).max() > 0.05


# -- path-length regularization ------------------------------------------------


def test_path_length_penalty_on_the_analytic_linear_map():
    """tests/test_plr.py:32 on the port: for w -> w @ A the Jacobian is A, so
    pl_i = ||y_i @ A^T|| exactly."""
    b, s_dim, h, w, c = 3, 6, 4, 4, 2
    a_key, w_key, y_key = jax.random.split(jax.random.PRNGKey(0), 3)
    a = _t(jax.random.normal(a_key, (s_dim, h * w * c)))
    ws = _t(jax.random.normal(w_key, (b, s_dim))).requires_grad_(True)
    y = _t(jax.random.normal(y_key, (b, h, w, c)))
    pen, pl_mean = port_losses.gen_path_length_penalty(
        lambda w_: (w_ @ a).reshape(b, h, w, c), ws, torch.tensor(0.7), y
    )
    grads = (y.numpy() / np.sqrt(h * w)).reshape(b, -1) @ a.numpy().T
    pl_exact = np.sqrt((grads.astype(np.float64) ** 2).sum(axis=1) + 1e-8)
    np.testing.assert_allclose(float(pl_mean), pl_exact.mean(), rtol=1e-5)
    np.testing.assert_allclose(float(pen), ((pl_exact - 0.7) ** 2).mean(), rtol=1e-5)


def _noisy(params, seed=21):
    """Generator params with random noise weights (zero at init, which would
    hide the noise path)."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (0.3 * r.standard_normal(v.shape)).astype(np.float32)
        if any(getattr(k, "key", None) == "noise" for k in path) else np.asarray(v),
        params,
    )


def test_path_length_penalty_matches_jax_on_a_2_stage_generator(small_jax):
    from byogan_tpu.core.random import synthesis_noise, truncated_noise
    from byogan_tpu.train import losses as jax_losses

    jgen, _, jstate = small_jax
    gp = _noisy(jstate.gen_params)
    zk, nk, yk = jax.random.split(jax.random.PRNGKey(5), 3)
    n, alpha, pl_ema = 2, 0.4, 0.3
    zp = truncated_noise(zk, n, 32, 0.75, jnp.float32)
    noise = synthesis_noise(nk, n, STEPS)

    def jpen(p):
        w = jgen.apply({"params": p}, zp, method="map_latent")

        def synth(w_):
            return jgen.apply({"params": p}, None, noise, steps=STEPS, alpha=jnp.float32(alpha), style=[w_] * STEPS)

        return jax_losses.gen_path_length_penalty(synth, w, jnp.float32(pl_ema), yk)

    (want_pen, want_mean), want_grads = jax.jit(jax.value_and_grad(jpen, has_aux=True))(gp)
    gen, _ = _port_models(jstate)
    gen.load_state_dict(generator_state_from_jax(gp), strict=True)
    y = _t(jax.random.normal(yk, (n, 8, 8, 3)))
    w = gen.map_latent(_t(zp))
    pen, pl_mean = port_losses.gen_path_length_penalty(
        lambda w_: gen(None, [_t(x) for x in noise], steps=STEPS, alpha=alpha, style=[w_] * STEPS),
        w, torch.tensor(pl_ema), y,
    )
    assert_rel(pen.item(), float(want_pen), what="penalty")
    assert_rel(pl_mean.item(), float(want_mean), what="pl_mean")
    grads = torch.autograd.grad(pen, list(gen.parameters()), allow_unused=True)
    want = generator_state_from_jax(want_grads)
    reached = 0
    for (name, _), g in zip(gen.named_parameters(), grads):
        got = np.zeros(want[name].shape) if g is None else g.numpy()
        assert_rel(got, want[name].numpy(), what=name)
        reached += bool(np.abs(want[name].numpy()).max() > 0)
    # every stage-1 and stage-2 module and the mapping net get a gradient
    assert reached >= 20, reached


# -- the Functions' second derivative --------------------------------------------


@pytest.mark.parametrize("case", ["styleconv (2,8,8,16->24)", "styleconv (1,16,16,8->8)", "epilogue (3,4,4,16)"])
def test_second_derivative_matches_plain_autograd(case):
    if case.startswith("styleconv"):
        shape = (2, 8, 8, 16, 24) if "16->24" in case else (1, 16, 16, 8, 8)
        ins = as_torch(styleconv_inputs(*shape, seed=3), torch.float32)
        with torch.no_grad():
            positive = styleconv_plain(**ins, with_stats=True)[1] >= 0
        fn, plain = (lambda *a: StyleConvFunction.apply(*a, 1e-8)), (lambda *a: styleconv_plain(*a, positive=positive))
    else:
        ins = as_torch(epilogue_inputs((3, 4, 4, 16), seed=4), torch.float32)
        fn, plain = (lambda *a: NoiseLReLUAdaINFunction.apply(*a, 1e-8)), noise_lrelu_adain_plain
    got_first, got = second_derivatives(fn, ins, 0)
    want_first, want = second_derivatives(plain, ins, 0)
    for i, (g, w) in enumerate(zip(got_first + got, want_first + want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert_rel(g.numpy(), w.numpy(), what=f"{case} derivative {i}")


# -- whole train steps -----------------------------------------------------------


def _regularizer_draws(rng, jcfg, iters, res):
    """The JAX step's draws from ``rng`` (``_jax_draws``), with its
    augmentation keys (steps.py:195-197, 274: each critic repeat's key
    split into the reals' and the fakes') and, on a penalized iteration,
    its path-length keys (steps.py:315-324) replayed."""
    from byogan_tpu.core.random import synthesis_noise, truncated_noise

    draws, _ = _jax_draws(rng, jcfg, STEPS)
    aug = []
    for _ in range(jcfg.critic_repeats):
        rng, _, _, _, aug_key = jax.random.split(rng, 5)
        aug += [_aug_draws(k, BATCH, res, res) for k in jax.random.split(aug_key)]
    rng, _, _, g_aug_key = jax.random.split(rng, 4)
    if jcfg.use_aug:
        draws.aug = aug + [_aug_draws(g_aug_key, BATCH, res, res)]
    if jcfg.plr_weight > 0 and iters % jcfg.plr_interval == 0:
        _, zk, nk, yk = jax.random.split(rng, 4)
        n = max(1, BATCH // jcfg.plr_batch_shrink)
        draws.plr = port_steps.PLRDraws(
            _t(truncated_noise(zk, n, jcfg.noise_size, jcfg.noise_trunc, jnp.float32)),
            [_t(x) for x in synthesis_noise(nk, n, STEPS, dtype=jnp.float32)],
            _t(jax.random.normal(yk, (n, res, res, 3), jnp.float32)),
        )
    return draws


@pytest.mark.parametrize(
    "knobs,fade",
    [
        (dict(plr_weight=2.0, plr_interval=2, ada_target=0.6, aug_p=0.5), True),
        (dict(aug_p=0.3, use_r1=False), False),
    ],
    ids=["plr_ada_r1", "aug_wgan_gp"],
)
def test_regularized_train_steps_match_jax(small_jax, knobs, fade):
    """Three whole steps with JAX's draws replayed: ADA (started inside (0,
    1), so the controller's steps show) and PLR on iterations 0 and 2; and
    fixed-probability augmentation under WGAN-GP."""
    from byogan_tpu.train.steps import make_train_step

    jcfg = small_config(**knobs)
    jgen, jcritic, jstate = small_jax
    jstate = jstate.replace(
        aug_p=jnp.float32(jcfg.aug_p) if jcfg.use_aug else None,
        rt_ema=jnp.float32(0.0) if jcfg.ada_target > 0 else None,
        pl_ema=jnp.float32(0.0) if jcfg.plr_weight > 0 else None,
    )
    pcfg, pstate = _port_state(jcfg, jstate)
    fade_in = 10.0
    jstep = make_train_step(jgen, jcritic, jcfg, steps=STEPS, batch=BATCH, fade_in=fade_in,
                            critic_fade=(fade,), gen_fade=fade, donate=False)
    pstep = port_steps.make_train_step(pcfg, STEPS, BATCH, fade_in, (fade,), fade)
    real = np.random.default_rng(9).integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
    for i in range(3):
        draws = _regularizer_draws(jstate.rng, jcfg, i, 8)
        jstate, jm = jstep(jstate, jnp.asarray(real))
        pm = pstep(pstate, torch.from_numpy(real), draws)
        assert set(pm) == set(jm), (sorted(pm), sorted(jm))
        for k in jm:
            assert_rel(float(pm[k]), float(jm[k]), what=f"step {i} {k}")
        if "pl_penalty" in jm:
            assert (float(pm["pl_penalty"]) > 0) == (i % 2 == 0), i
    for k in ("aug_p", "rt_ema", "pl_ema"):
        if getattr(jstate, k) is not None:
            assert_rel(float(getattr(pstate, k)), float(getattr(jstate, k)), what=k)
    if jcfg.ada_target > 0:  # rt_ema < 0.6: one step down an iteration (three f32 roundings at 0.5)
        assert float(pstate.aug_p) == pytest.approx(0.5 - 3 * BATCH / jcfg.ada_speed, abs=2e-7)
    _assert_params(pstate.gen.state_dict(), generator_state_from_jax(jstate.gen_params))
    _assert_params(pstate.critic.state_dict(), critic_state_from_jax(jstate.critic_params))


def _draw_state(rng, iters=0):
    return types.SimpleNamespace(rng=rng, iters=iters)


def test_default_step_draws_what_it_drew_before():
    """With augmentation and PLR off, ``draw`` makes exactly the default
    path's draws (z, noise, eps per repeat; z, noise), nothing more, and
    leaves the generator where the old sequence left it."""
    for use_r1 in (True, False):
        cfg = PortConfig(noise_size=16, use_r1=use_r1, critic_repeats=2)
        state = types.SimpleNamespace(rng=torch.Generator().manual_seed(4))  # no iters: not read without PLR
        draws = port_steps.draw(state, cfg, 3, 2, torch.float32)
        rng = torch.Generator().manual_seed(4)
        for z, noise, eps in draws.critic:
            torch.testing.assert_close(z, port_latents(rng, 3, 16, 0.75), rtol=0, atol=0)
            for a, b in zip(noise, port_noise(rng, 3, 2)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            if not use_r1:
                torch.testing.assert_close(eps, torch.rand((3, 1, 1, 1), generator=rng), rtol=0, atol=0)
        torch.testing.assert_close(draws.gen[0], port_latents(rng, 3, 16, 0.75), rtol=0, atol=0)
        assert draws.aug is None and draws.plr is None and draws.mix is None
        for a, b in zip(draws.gen[1], port_noise(rng, 3, 2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert torch.equal(state.rng.get_state(), rng.get_state())


def test_draw_makes_the_regularizers_draws():
    """Augmentation draws for each critic repeat's reals and fakes and for
    the generator phase; PLR's on penalized iterations only, at batch //
    plr_batch_shrink."""
    cfg = PortConfig(noise_size=16, critic_repeats=2, ada_target=0.6, plr_weight=2.0, plr_interval=3)
    for iters, plr in ((0, True), (1, False), (3, True)):
        draws = port_steps.draw(_draw_state(torch.Generator().manual_seed(1), iters), cfg, 5, 3, torch.float32)
        assert len(draws.aug) == 5 and all(d.flip.shape == (5,) and int(d.cy.max()) < 16 for d in draws.aug)
        assert all(int(d.ty.abs().max()) <= 2 for d in draws.aug)
        assert (draws.plr is not None) == plr
        if plr:
            assert draws.plr.z.shape == (2, 16) and draws.plr.y.shape == (2, 16, 16, 3)
            assert [n.shape[1] for n in draws.plr.noise] == [4, 8, 16]


def test_step_refuses_draws_or_state_that_do_not_match_the_config():
    cfg = PortConfig(noise_size=16, compute_dtype="float32", channel_divisor=32, mapping_depth=2,
                     batch_progression=(4,), epoch_progression=(1,), plr_weight=2.0, aug_p=0.3)
    state = build_state(cfg, torch.device("cpu"))
    step = port_steps.make_train_step(cfg, 1, 4, 10.0, (False,), False)
    real = torch.zeros((4, 4, 4, 3), dtype=torch.uint8)
    draws = port_steps.draw(state, cfg, 4, 1, torch.float32)
    with pytest.raises(ValueError, match="draws.plr"):
        step(state, real, dataclasses.replace(draws, plr=None))
    with pytest.raises(ValueError, match="draws.aug"):
        step(state, real, dataclasses.replace(draws, aug=None))
    state.pl_ema = None
    with pytest.raises(ValueError, match="pl_ema"):
        step(state, real, draws)


# -- config, checkpoint, CLI -----------------------------------------------------


def test_config_takes_the_regularizers_and_keeps_jax_checks():
    for knob in (dict(aug_p=0.3), dict(ada_target=0.6), dict(plr_weight=2.0)):
        assert PortConfig(**knob).use_aug == ("plr_weight" not in knob)
    assert not PortConfig().use_aug
    assert PortConfig(model_axis=2).model_axis == 2  # ported: parallel/tensor.py
    with pytest.raises(ValueError, match="model_axis must be >= 1, got 1, 0"):
        PortConfig(model_axis=0)
    assert PortConfig(data_axis=2).data_axis == 2  # ported: parallel/mesh.py
    for knob in (dict(remat=True), dict(remat_progression=(True,) * 8)):  # ported: they construct
        PortConfig(**knob)
    with pytest.raises(ValueError, match="ada_target > 0 requires use_r1"):
        PortConfig(ada_target=0.6, use_r1=False)
    PortConfig(aug_p=0.3, use_r1=False)
    for bad in (dict(plr_interval=0), dict(plr_batch_shrink=0)):
        with pytest.raises(ValueError, match="plr_interval and plr_batch_shrink"):
            PortConfig(plr_weight=2.0, **bad)
    PortConfig(plr_interval=0)  # checked only with PLR on, as in JAX


def _tiny(**kw):
    return PortConfig(noise_size=16, compute_dtype="float32", channel_divisor=32, mapping_depth=2,
                      batch_progression=(4,), epoch_progression=(1,), **kw)


def test_checkpoint_round_trip_and_resume_from_before_the_regularizers(tmp_path):
    cfg = _tiny(ada_target=0.6, aug_p=0.25, plr_weight=2.0)
    state = build_state(cfg, torch.device("cpu"))
    assert [float(state.aug_p), float(state.rt_ema), float(state.pl_ema)] == [0.25, 0.0, 0.0]
    values = {"aug_p": 0.3125, "rt_ema": -0.4375, "pl_ema": 1.7109375}
    for k, v in values.items():
        setattr(state, k, torch.tensor(v))
    path = save_checkpoint(str(tmp_path), state, None, name="reg", train_config=cfg)
    saved = torch.load(path, weights_only=False)
    assert {k: saved[k] for k in values} == values
    fresh = build_state(cfg, torch.device("cpu"))
    restore_train_state(path, fresh, cfg)
    assert {k: float(getattr(fresh, k)) for k in values} == values
    assert all(getattr(fresh, k).dtype == torch.float32 for k in values)
    # a checkpoint written before the regularizers: aug_p from the config, the others at 0
    plain_cfg = _tiny()
    old = save_checkpoint(str(tmp_path), build_state(plain_cfg, torch.device("cpu")), None, name="old",
                          train_config=plain_cfg)
    assert not any(k in torch.load(old, weights_only=False) for k in values)
    fresh = build_state(cfg, torch.device("cpu"))
    restore_train_state(old, fresh, cfg, allow_mismatch=True)
    assert [float(fresh.aug_p), float(fresh.rt_ema), float(fresh.pl_ema)] == [0.25, 0.0, 0.0]


def test_cli_trains_with_the_regularizers_on_the_cpu(tmp_path, capsys):
    from byogan_tpu_torch.cli.main import main

    root = write_prepared_dataset(str(tmp_path / "data"), 4, 2, seed=3)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        "[reg]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 32\n"
        "mapping_depth = 2\nbatch_progression = 4,4\nepoch_progression = 3,3\nrefresh_stat_step = 1\n"
        "ada_target = 0.6\naug_p = 0.2\nplr_weight = 2.0\nplr_interval = 2\n"
        f"checkpoint_dir = {tmp_path / 'ck'}\noutput_dir = {tmp_path / 'out'}\n"
    )
    state = main(["reg", "--config-file", str(cfg), "-d", "cpu", "--max-iters", "4"])
    assert state.iters == 4
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 4
    for r in records:
        assert {"aug_p", "rt_ema", "pl_ema", "pl_penalty", "rt"} <= set(r), r
        assert all(np.isfinite(r[k]) for k in ("c_loss", "g_loss", "pl_ema", "pl_penalty"))
    assert [r["pl_penalty"] > 0 for r in records] == [True, False, True, False]
    assert records[0]["pl_ema"] > 0
    assert "pl_ema:" in capsys.readouterr().out
    saved = torch.load(tmp_path / "ck" / "chk-4.pth", weights_only=False)
    assert all(isinstance(saved[k], float) for k in ("aug_p", "rt_ema", "pl_ema"))
    resumed = main(["reg", "--config-file", str(cfg), "-d", "cpu", "-c", str(tmp_path / "ck" / "chk-4.pth")])
    assert resumed.iters == 6 and os.path.exists(tmp_path / "ck" / "FINAL.pth")
