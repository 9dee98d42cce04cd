"""The port's Generator against the JAX package's, on the CPU.

One JAX param tree (small channels, noise weights and conv biases
perturbed) is carried across by ``generator_state_from_jax``; the same
numpy latents, noise maps and styles go through both generators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.compat.torch_ckpt import generator_state_from_jax
from byogan_tpu_torch.models.factory import ModelSpec, build_generator
from byogan_tpu_torch.models.generator import Generator as PortGenerator
from tests.conftest import SMALL_GEN_CHANNELS

Z_DIM = STYLE_DIM = 32
BATCH = 2
# f32 through up to 6 convs and instance norms: float rounding only.
ATOL = 2e-4


def _perturb(params, rng):
    """Give every noise weight and conv bias nonzero values (both are
    zero-initialised, which would hide the noise path)."""
    out = jax.tree_util.tree_map(np.asarray, params)
    for name, stage in out.items():
        if not name.startswith("stages_"):
            continue
        for conv in stage.values():
            conv["noise"]["weight"] = (
                0.3 * rng.standard_normal(conv["noise"]["weight"].shape)
            ).astype(np.float32)
            if "conv" in conv:
                conv["conv"]["bias"] = (
                    0.1 * rng.standard_normal(conv["conv"]["bias"].shape)
                ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    from byogan_tpu.core.random import synthesis_noise as jax_noise
    from byogan_tpu.models import Generator

    jgen = Generator(channels=SMALL_GEN_CHANNELS, style_dim=STYLE_DIM, mapping_depth=2)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, Z_DIM))
    init = jax.jit(functools.partial(jgen.init, steps=1))  # jitted: 2x quicker
    params = init(key, z0, jax_noise(key, 1, 3))["params"]
    params = _perturb(params, np.random.default_rng(0))
    port = PortGenerator(
        channels=SMALL_GEN_CHANNELS, style_dim=STYLE_DIM, mapping_depth=2, z_dim=Z_DIM
    )
    port.load_state_dict(generator_state_from_jax(params), strict=True)
    port.eval()

    r = np.random.default_rng(1)
    z = np.clip(r.standard_normal((BATCH, Z_DIM)), -0.75, 0.75).astype(np.float32)
    noise = [
        r.standard_normal((BATCH, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32)
        for i in range(3)
    ]
    styles = [r.standard_normal((BATCH, STYLE_DIM)).astype(np.float32) for _ in range(3)]
    return params, port, z, noise, styles


def _jax_out(params, use_pallas, monkeypatch, z, noise, steps, alpha, style=None):
    from byogan_tpu.models import Generator
    from byogan_tpu.ops import pallas_styleconv as sc

    monkeypatch.setattr(sc, "_INTERPRET", True)
    jgen = Generator(
        channels=SMALL_GEN_CHANNELS, style_dim=STYLE_DIM, mapping_depth=2,
        use_pallas=use_pallas,
    )
    return np.asarray(
        jgen.apply(
            {"params": params}, None if z is None else jnp.asarray(z),
            [jnp.asarray(n) for n in noise], steps=steps,
            alpha=None if alpha is None else jnp.float32(alpha), style=style,
        )
    )


def _port_out(port, z, noise, steps, alpha, style=None):
    with torch.no_grad():
        return port(
            None if z is None else torch.from_numpy(z),
            [torch.from_numpy(n) for n in noise], steps=steps, alpha=alpha,
            style=style,
        ).numpy()


def test_state_from_jax_matches_reference_converter(models):
    from byogan_tpu.compat.torch_ckpt import generator_params_to_torch

    params, port, *_ = models
    want = generator_params_to_torch(
        params, num_stages=3, mapping_depth=2, data_parallel_prefix=False
    )
    got = generator_state_from_jax(params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # Every key of the port module is a reference key, and vice versa.
    assert set(port.state_dict()) == set(want)


def test_full_spec_state_dict_keys_are_the_reference_keys():
    from byogan_tpu.compat.torch_ckpt import _generator_key_map

    gen = build_generator(ModelSpec())
    want = {k for k, _, _ in _generator_key_map()}
    assert set(gen.state_dict()) == want
    assert tuple(gen.state_dict()["gen_blocks.0.conv_1.conv"].shape) == (1, 512, 4, 4)
    assert tuple(gen.state_dict()["gen_blocks.7.conv_2.inject_noise.weights"].shape) == (1, 16, 1, 1)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("alpha", [None, 0.3])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_generator_matches_jax(models, monkeypatch, use_pallas, steps, alpha):
    params, port, z, noise, _ = models
    want = _jax_out(params, use_pallas, monkeypatch, z, noise, steps, alpha)
    got = _port_out(port, z, noise, steps, alpha)
    r = 4 * 2 ** (steps - 1)
    assert got.shape == (BATCH, r, r, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("per_stage", [False, True])
def test_style_injection_matches_jax(models, monkeypatch, per_stage):
    params, port, _, noise, styles = models
    jstyle = [jnp.asarray(s) for s in styles] if per_stage else jnp.asarray(styles[0])
    tstyle = [torch.from_numpy(s) for s in styles] if per_stage else torch.from_numpy(styles[0])
    want = _jax_out(params, False, monkeypatch, None, noise, 3, 0.6, style=jstyle)
    got = _port_out(port, None, noise, 3, 0.6, style=tstyle)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_map_latent_matches_jax(models):
    from byogan_tpu.models import Generator

    params, port, z, *_ = models
    jgen = Generator(channels=SMALL_GEN_CHANNELS, style_dim=STYLE_DIM, mapping_depth=2)
    want = jgen.apply({"params": params}, jnp.asarray(z), method="map_latent")
    with torch.no_grad():
        got = port.map_latent(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_alpha_is_clamped(models):
    _, port, z, noise, _ = models
    np.testing.assert_array_equal(
        _port_out(port, z, noise, 2, 1.7), _port_out(port, z, noise, 2, 1.0)
    )
    np.testing.assert_array_equal(
        _port_out(port, z, noise, 2, -0.5), _port_out(port, z, noise, 2, 0.0)
    )


def test_seeded_init_is_reproducible_and_reference_shaped():
    spec = ModelSpec(num_stages=2, channel_divisor=16, mapping_depth=2)
    a = build_generator(spec, generator=torch.Generator().manual_seed(3)).state_dict()
    b = build_generator(spec, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bias = a["gen_blocks.1.conv_2.adain.style.bias"]
    c = bias.shape[0] // 2
    assert torch.equal(bias[:c], torch.ones(c)) and torch.equal(bias[c:], torch.zeros(c))
    assert not a["gen_blocks.1.conv_1.inject_noise.weights"].any()
