"""The port's SWD and MS-SSIM metrics, evaluate CLI and periodic training
eval against the JAX package's, on the CPU.

The same numpy inputs go to both packages; where JAX draws from a key
(patch sites, projection directions), the test draws JAX's numbers from
that key and hands them to the port.  Tolerances: the pyramid at 1e-5,
patches exact, SWD at 1e-5 (one set) and 1e-4 (per level, relative),
MS-SSIM at 2e-4 (the JAX suite's oracle tolerance).
"""

import functools
import importlib
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.core.resize import upsample2x_bilinear
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.train import loop as port_loop
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.metrics import read_metrics

# The packages' eval/__init__ re-export functions named like the modules.
jswd = importlib.import_module("byogan_tpu.eval.swd")
jms = importlib.import_module("byogan_tpu.eval.msssim")
pswd = importlib.import_module("byogan_tpu_torch.eval.swd")
pms = importlib.import_module("byogan_tpu_torch.eval.msssim")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _images(seed, shape):
    """Smooth colour fields plus noise in [-1, 1]: structured enough that
    SSIM's terms are far from 0 and 1."""
    n, h, w, c = shape
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phase = r.random((n, 1, 1, c)) * 6.28
    img = 0.6 * np.sin(5 * xx[None, :, :, None] + phase) * np.cos(4 * yy[None, :, :, None] + phase)
    return np.clip(img + 0.2 * r.standard_normal(shape), -1, 1).astype(np.float32)


@pytest.mark.parametrize("size,min_size", [(64, 16), (32, 8), (16, 16)])
def test_laplacian_pyramid_matches_jax_and_reconstructs(size, min_size):
    x = _images(0, (2, size, size, 3))
    want = jswd.laplacian_pyramid(jnp.asarray(x), min_size)
    got = pswd.laplacian_pyramid(_t(x), min_size)
    assert [g.shape[1] for g in got] == [w.shape[1] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    recon = got[-1]
    for level in got[-2::-1]:
        recon = upsample2x_bilinear(recon) + level
    np.testing.assert_allclose(recon.numpy(), x, atol=1e-5, rtol=0)


def _jax_sites(key, n, h, w, ppi):
    patch = min(pswd.PATCH, h, w)
    ky, kx = jax.random.split(key)
    return tuple(
        _t(np.asarray(jax.random.randint(k, (n, ppi), 0, d - patch + 1), np.int64))
        for k, d in ((ky, h), (kx, w))
    )


def _jax_directions(key, dim, dirs_per_repeat, repeats):
    out = []
    for sub in jax.random.split(key, repeats):
        d = jax.random.normal(sub, (dim, dirs_per_repeat), jnp.float32)
        out.append(np.asarray(d / jnp.linalg.norm(d, axis=0, keepdims=True)))
    return _t(np.stack(out))


@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (2, 4, 4, 3), (2, 9, 13, 3)])
def test_extract_patches_with_jax_sites_is_exact(shape):
    x = _images(1, shape)
    key = jax.random.PRNGKey(7)
    want = jswd.extract_patches(jnp.asarray(x), key, 16)
    got = pswd.extract_patches(_t(x), sites=_jax_sites(key, *shape[:3], 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = pswd.extract_patches(_t(x), torch.Generator().manual_seed(0), 16)
    assert own.shape == want.shape


def test_sliced_wasserstein_with_jax_directions():
    r = np.random.default_rng(2)
    a = r.standard_normal((96, 7, 7, 3)).astype(np.float32)
    b = (1.2 * r.standard_normal((96, 7, 7, 3)) + 0.3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = float(jswd.sliced_wasserstein(jnp.asarray(a), jnp.asarray(b), key, 32, 3))
    got = float(pswd.sliced_wasserstein(_t(a), _t(b), directions=_jax_directions(key, 147, 32, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="equal descriptor counts"):
        pswd.sliced_wasserstein(_t(a), _t(b[:9]), torch.Generator())


def _jax_level_draws(key, real_levels, ppi, dirs_per_repeat, repeats):
    """JAX's key splits of sliced_wasserstein_distance, replayed as draws."""
    draws = []
    for level in real_levels:
        n, h, w, c = level.shape
        key, sub = jax.random.split(key)
        kr, kf, kp = jax.random.split(sub, 3)
        dim = min(pswd.PATCH, h, w) ** 2 * c
        draws.append(pswd.LevelDraws(
            _jax_sites(kr, n, h, w, ppi), _jax_sites(kf, n, h, w, ppi),
            _jax_directions(kp, dim, dirs_per_repeat, repeats),
        ))
    return draws


@pytest.mark.parametrize("size,min_size,uint8", [(16, 8, False), (16, 16, True), (4, 4, False)])
def test_swd_matches_jax_with_its_key_splits(size, min_size, uint8):
    real, fake = _images(3, (6, size, size, 3)), _images(4, (6, size, size, 3))
    if uint8:
        real = np.round((real + 1) * 127.5).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    kw = dict(patches_per_image=16, min_size=min_size, dirs_per_repeat=32, repeats=2)
    want = jswd.sliced_wasserstein_distance(jnp.asarray(real), jnp.asarray(fake), key, **kw)
    levels = jswd.laplacian_pyramid(jnp.zeros((6, size, size, 3)), min_size)
    draws = _jax_level_draws(key, levels, 16, 32, 2)
    got = pswd.sliced_wasserstein_distance(_t(real), _t(fake), draws=draws, **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=str(k))
    own = pswd.sliced_wasserstein_distance(_t(real), _t(fake), torch.Generator().manual_seed(0), **kw)
    assert list(own) == list(want) and all(np.isfinite(v) and v >= 0 for v in own.values())


def test_swd_checks_sizes_and_summary_cuts_to_the_shorter_set():
    a = _t(_images(5, (4, 16, 16, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        pswd.sliced_wasserstein_distance(a, a[:2], torch.Generator())
    with pytest.raises(ValueError, match="SWD needs >= 32px"):
        pswd.sliced_wasserstein_distance(a, a, torch.Generator(), min_size=32)
    got = pswd.swd_summary([a[:2], a[2:]], [a[:3]], seed=1, patches_per_image=8)
    assert got == pswd.sliced_wasserstein_distance(
        a[:3], a[:3], torch.Generator().manual_seed(1), patches_per_image=8
    )
    sites = pswd.patch_sites(torch.Generator().manual_seed(2), 3, 16, 16, 8)
    same = pswd.LevelDraws(sites, sites, pswd.unit_directions(torch.Generator(), 147))
    assert pswd.sliced_wasserstein_distance(a[:3], a[:3], draws=[same], patches_per_image=8)[0] == 0.0


@pytest.mark.parametrize("size", [4, 24, 48])  # 1 (window clamped), 2 and 3 scales
def test_msssim_matches_jax(size):
    a, b = _images(6, (3, size, size, 3)), _images(7, (3, size, size, 3))
    b = (0.7 * a + 0.3 * b).astype(np.float32)  # related pairs
    want = np.asarray(jms.msssim(jnp.asarray(a), jnp.asarray(b)))
    got = pms.msssim(_t(a), _t(b)).numpy()
    assert 0.05 < want.min() and want.max() < 0.999, want
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    u8 = np.round((np.concatenate([a, b]) + 1) * 127.5).astype(np.uint8)
    np.testing.assert_allclose(
        float(pms.msssim_diversity(_t(u8))), float(jms.msssim_diversity(jnp.asarray(u8))), atol=2e-4, rtol=0,
    )
    with pytest.raises(ValueError, match="shape mismatch"):
        pms.msssim(_t(a), _t(b[:2]))
    with pytest.raises(ValueError, match="at least 2 images"):
        pms.msssim_diversity(_t(a[:1]))


# -- the evaluate CLI ----------------------------------------------------------

SPEC = dict(num_stages=2, channel_divisor=16, mapping_depth=2)


@functools.lru_cache(maxsize=None)
def _jax_params():
    from byogan_tpu.core.random import synthesis_noise
    from byogan_tpu.models.factory import ModelSpec, build_generator

    jgen = build_generator(ModelSpec(**SPEC))
    key = jax.random.PRNGKey(2)
    init = jax.jit(functools.partial(jgen.init, steps=1))
    return jax.tree_util.tree_map(np.asarray, init(key, jnp.zeros((1, 16)), synthesis_noise(key, 1, 1))["params"])


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A small JAX-initialised generator as a .pth at stage 2 (8 px), and
    two datasets: 6 images and 1 image."""
    from byogan_tpu.compat.torch_ckpt import generator_params_to_torch
    from byogan_tpu.models.factory import ModelSpec

    root = tmp_path_factory.mktemp("eval")
    state = generator_params_to_torch(_jax_params(), num_stages=2, mapping_depth=2)
    path = str(root / "gen.pth")
    torch.save({"gen": {k: torch.tensor(v) for k, v in state.items()}, "step": 2, "alpha": None,
                "model": ModelSpec(**SPEC).to_dict()}, path)
    data = write_prepared_dataset(str(root / "data"), 6, 2, seed=1)
    one = write_prepared_dataset(str(root / "one"), 1, 2, seed=2)
    return path, data, one


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _schema(d):
    return [(k, _schema(v) if isinstance(v, dict) else type(v).__name__) for k, v in d.items()]


@pytest.mark.parametrize("dataset,args", [
    ("data", ["-n", "4", "--patches", "8", "--metric", "both"]),
    ("one", ["-n", "2", "--patches", "8", "--metric", "msssim", "-t", "0.5"]),
])
def test_evaluate_cli_prints_jax_schema(eval_run, capsys, dataset, args):
    from byogan_tpu import serve as jax_serve
    from byogan_tpu.cli.evaluate import main as jax_main
    from byogan_tpu_torch.cli.evaluate import main

    path, data, one = eval_run
    root = data if dataset == "data" else one
    # byogan_tpu's .pth reader assumes 8 stages and mapping depth 8: hand
    # its Sampler the same weights as a loaded checkpoint instead.
    jax_save = {"gen_params": _jax_params(), "step": 2, "alpha": None, "model": SPEC}
    with mock.patch.object(jax_serve, "load_checkpoint", lambda _: dict(jax_save)):
        jax_main([path, root, "-d", "cpu"] + args)
    want = _last_json(capsys)
    main([path, root, "-d", "cpu"] + args)
    captured = capsys.readouterr()
    got = json.loads(captured.out.strip().splitlines()[-1])
    assert _schema(got) == _schema(want)
    for k in ("metric", "resolution", "n_images", "resampled", "ema", "truncation"):
        assert got[k] == want[k], k
    if dataset == "one":  # resampled: the warning, and no real anchor for one image
        assert "WITH replacement" in captured.err
        assert got["msssim_diversity"]["real"] is None and got["msssim_diversity"]["real_n"] == 1
    if "per_level" in got:
        assert list(got["per_level"]) == ["8"] and np.isfinite(got["mean"])


# -- periodic eval in the training loop ---------------------------------------

EVAL_KEYS_CONFIG = dict(
    noise_size=16, compute_dtype="float32", channel_divisor=16, mapping_depth=2,
    batch_progression=(4, 4), epoch_progression=(1, 1), display_step=100, checkpoint_step=100,
    refresh_stat_step=2, eval_images=8, ema_beta=0.5, show_noise_count=4, seed=9,
)


def _jax_eval_keys(tmp_path, data):
    """The keys of one JAX eval record, from the JAX loop's own eval
    function on a small state with an EMA, at stage 1."""
    from byogan_tpu.data.pipeline import open_stage_dataset
    from byogan_tpu.models.factory import ModelSpec, build_critic, build_generator
    from byogan_tpu.train import loop as jax_loop
    from byogan_tpu.train.config import TrainConfig
    from byogan_tpu.train.metrics import MetricsLogger as JaxLogger
    from byogan_tpu.train.state import create_train_state

    config = TrainConfig(data=data, **EVAL_KEYS_CONFIG)
    spec = ModelSpec(**SPEC)
    gen = build_generator(spec)
    state = create_train_state(config, gen, build_critic(spec))
    path = tmp_path / "jax.jsonl"
    logger = JaxLogger(jsonl_path=str(path), print_fn=lambda *_: None)
    jax_loop._log_swd_eval(gen, config, state, open_stage_dataset(data, 1), 1, False, None, 2, {}, logger)
    logger.close()
    (rec,) = [json.loads(line) for line in open(path)]
    return list(rec)


def test_periodic_eval_logs_jax_keys_and_leaves_training_unchanged(tmp_path):
    data = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=3)
    states = {}
    for eval_step in (0, 2):
        config = PortConfig(
            data=data, eval_step=eval_step, checkpoint_dir=str(tmp_path / f"ck{eval_step}"),
            output_dir=str(tmp_path / f"out{eval_step}"), **EVAL_KEYS_CONFIG,
        )
        states[eval_step] = port_loop.train(config, device="cpu")
    evals = read_metrics(str(tmp_path / "out2" / "metrics.jsonl"), kind="eval")
    assert [(r["iter"], r["stage"]) for r in evals] == [(2, 1), (4, 2)]
    want = _jax_eval_keys(tmp_path, data)
    for r in evals:
        assert list(r) == want
        assert all(0.0 <= r[k] <= 1.0 for k in ("msssim", "msssim_ema", "msssim_real"))
        assert r["swd"] >= 0 and r["swd_ema"] >= 0
    assert not read_metrics(str(tmp_path / "out0" / "metrics.jsonl"), kind="eval")
    assert len(read_metrics(str(tmp_path / "out2" / "metrics.jsonl"))) == len(evals) + 2
    for net in ("gen", "gen_ema", "critic"):
        a, b = (getattr(states[k], net).state_dict() for k in (0, 2))
        for name in a:
            assert torch.equal(a[name], b[name]), (net, name)


def test_evict_stage_cache_keeps_the_current_stage():
    cache = {("real", 1): 0, ("msssim_real", 1): 1, ("real", 2): 2, ("msssim_real", 2): 3}
    port_loop.evict_stage_cache(cache, 2)
    assert cache == {("real", 2): 2, ("msssim_real", 2): 3}


def test_log_eval_without_ema_and_with_one_image(tmp_path):
    """One image: no MS-SSIM keys (as JAX, which needs 2); no EMA: no
    swd_ema.  The real subset is cached per stage."""
    from byogan_tpu_torch.data.pipeline import open_stage_dataset
    from byogan_tpu_torch.train.metrics import MetricsLogger

    data = write_prepared_dataset(str(tmp_path / "data"), 1, 2, seed=4)
    cfg = dict(EVAL_KEYS_CONFIG, ema_beta=0.0)
    config = PortConfig(data=data, **cfg)
    state = port_loop.build_state(config, torch.device("cpu"))
    cache = {}
    logger = MetricsLogger(None, print_fn=lambda *_: None)
    values = port_loop.log_eval(state, config, open_stage_dataset(data, 2), 2, 0.5, 6, cache, logger)
    assert list(values) == ["swd"] and np.isfinite(values["swd"])
    assert list(cache) == [("real", 2)] and cache[("real", 2)].shape == (1, 8, 8, 3)
