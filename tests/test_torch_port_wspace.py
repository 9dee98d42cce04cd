"""The port's W-space projection, SeFa editing, interpolation walks and
their CLIs against the JAX package's, on the CPU.

Small model (3 stages, 16 px), f32, JAX-initialised weights loaded into the
port.  The same numpy inputs go to both packages; where JAX draws
synthesis noise from a key, the test draws it from that key and hands it
to the port.  Tolerances: forwards and the first gradient at 2e-4 of the
max, loss trajectories at 1e-3 relative, final latents with at most 0.1%
of elements beyond 1e-4 (Adam's steps by the sign of near-zero gradients,
ROADMAP §3), SeFa eigenvalues at 1e-4 relative and directions equal up to
sign within 1e-5.
"""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.cli.interpolate import render_pair
from byogan_tpu_torch.compat.torch_ckpt import generator_state_from_jax
from byogan_tpu_torch.core.grids import uint8_to_training_range
from byogan_tpu_torch.editing import edit_sheet, sefa_directions, style_projection_matrix
from byogan_tpu_torch.models.factory import ModelSpec, build_generator
from byogan_tpu_torch.projector import project, projection_loss

SPEC = dict(num_stages=3, channel_divisor=16, style_dim=512, mapping_depth=2)
STEPS, ALPHA, Z_DIM, RES = 3, 0.4, 32, 16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_rel(got, want, tol=2e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * max(float(np.abs(want).max()), 1e-6), rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX generator, its params, EMA params, the port generator, a .pth
    holding both weight sets); noise weights perturbed so noise shows."""
    from byogan_tpu.compat.torch_ckpt import generator_params_to_torch
    from byogan_tpu.core.random import synthesis_noise as jax_noise
    from byogan_tpu.models.factory import ModelSpec as JaxSpec
    from byogan_tpu.models.factory import build_generator as jax_build

    jgen = jax_build(JaxSpec(**SPEC))
    key = jax.random.PRNGKey(4)
    init = jax.jit(functools.partial(jgen.init, steps=1))
    params = jax.tree_util.tree_map(np.asarray, init(key, jnp.zeros((1, Z_DIM)), jax_noise(key, 1, STEPS))["params"])
    rng = np.random.default_rng(5)
    for k in range(STEPS):
        for conv in ("conv1", "conv2"):
            w = params[f"stages_{k}"][conv]["noise"]["weight"]
            params[f"stages_{k}"][conv]["noise"]["weight"] = (0.3 * rng.standard_normal(w.shape)).astype(np.float32)
    ema = jax.tree_util.tree_map(lambda v: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32), params)
    gen = build_generator(ModelSpec(**SPEC), z_dim=Z_DIM)
    gen.load_state_dict(generator_state_from_jax(params), strict=True)

    def sd(tree):
        return {k: torch.tensor(v) for k, v in generator_params_to_torch(tree, num_stages=STEPS, mapping_depth=2).items()}

    path = str(tmp_path_factory.mktemp("ckpt") / "gen.pth")
    torch.save({"gen": sd(params), "gen_ema": sd(ema), "step": STEPS, "alpha": ALPHA,
                "model": ModelSpec(**SPEC).to_dict()}, path)
    return jgen, params, ema, gen, path


def _jax_noise(seed, batch, steps=STEPS):
    from byogan_tpu.core.random import synthesis_noise

    return [np.asarray(m) for m in synthesis_noise(jax.random.PRNGKey(seed), batch, steps)]


@pytest.fixture(scope="module")
def targets(models):
    """seed -> (target, start w): a target rendered from a known w with the
    projector's own noise (noise_seed 0), so an exact inversion exists, and
    the mean of two other w's as the start."""
    jgen, params = models[:2]

    @jax.jit
    def render(z, noise):
        w = jgen.apply({"params": params}, z, method="map_latent")
        return jgen.apply({"params": params}, None, noise, steps=STEPS, style=w[:2]), w[2:].mean(axis=0)

    out = {}
    for seed in (3, 7, 9):
        z = np.clip(np.random.default_rng(seed).standard_normal((4, Z_DIM)), -0.75, 0.75).astype(np.float32)
        img, w0 = render(jnp.asarray(z), [jnp.asarray(n) for n in _jax_noise(0, 2)])
        out[seed] = np.array(img, np.float32), np.array(w0)
    return out


# -- project --------------------------------------------------------------------


@pytest.mark.parametrize("w_plus", [False, True])
def test_first_projection_gradient_matches_jax(models, targets, w_plus):
    from byogan_tpu.eval.swd import laplacian_pyramid as jax_pyramid
    from byogan_tpu.projector import _pyramid_loss as jax_loss

    jgen, params, _, gen, _ = models
    target, w0 = targets[3]
    w_init = np.broadcast_to(w0, (2, STEPS, w0.size) if w_plus else (2, w0.size)).copy()
    noise = _jax_noise(0, 2)

    def loss(w):
        style = [w[:, i] for i in range(STEPS)] if w_plus else w
        img = jgen.apply({"params": params}, None, [jnp.asarray(n) for n in noise], steps=STEPS, alpha=jnp.float32(ALPHA),
                         style=style).astype(jnp.float32)
        return jax_loss(img, jnp.asarray(target), jax_pyramid(jnp.asarray(target), min_size=8))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(jnp.asarray(w_init))
    w = _t(w_init).requires_grad_(True)
    got_loss = projection_loss(gen, w, _t(target), [_t(n) for n in noise], STEPS, ALPHA)
    (got,) = torch.autograd.grad(got_loss, w)
    assert_rel(got_loss.detach().numpy(), np.asarray(want_loss), what="loss")
    assert_rel(got.numpy(), np.asarray(want), what="dL/dw")


@pytest.mark.parametrize("w_plus,alpha,uint8", [(False, None, False), (True, ALPHA, True)])
def test_project_matches_jax(models, targets, w_plus, alpha, uint8):
    from byogan_tpu.projector import project as jax_project

    jgen, params, _, gen, _ = models
    target, w0 = targets[7]
    if uint8:
        target = np.round((np.clip(target, -1, 1) + 1) * 127.5).astype(np.uint8)
    target = np.array(target)  # writable, for torch.from_numpy
    w_init = np.broadcast_to(w0, (2, STEPS, w0.size) if w_plus else (2, w0.size)).copy()
    kw = dict(steps=STEPS, z_dim=Z_DIM, n_iters=5, lr=0.05, w_plus=w_plus, alpha=alpha)
    want = jax_project(jgen, {"params": params}, target, w_init=jnp.asarray(w_init), noise_seed=0, **kw)
    got = project(gen, torch.from_numpy(target), w_init=_t(w_init), noise=[_t(n) for n in _jax_noise(0, 2)], **kw)
    assert got.losses.shape == (5,) and got.w.shape == w_init.shape and got.image.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-3)
    d = np.abs(got.w.numpy() - np.asarray(want.w))
    assert (d > 1e-4).mean() <= 1e-3, (d > 1e-4).mean()
    assert_rel(got.image.numpy(), np.asarray(want.image), tol=2e-3, what="image")
    assert all(p.requires_grad for p in gen.parameters())  # flags restored


def test_project_from_the_mean_w_converges_and_checks_its_inputs(models, targets):
    gen = models[3]
    target, _ = targets[9]
    result = project(gen, _t(target), STEPS, Z_DIM, n_iters=40, lr=0.05)
    losses = result.losses.numpy()
    assert np.all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses
    u8 = np.zeros((1, RES, RES, 3), np.uint8)
    a = project(gen, u8, STEPS, Z_DIM, n_iters=2, noise_seed=3)
    b = project(gen, uint8_to_training_range(torch.from_numpy(u8)), STEPS, Z_DIM, n_iters=2, noise_seed=3)
    assert torch.equal(a.losses, b.losses) and torch.equal(a.w, b.w)
    with pytest.raises(ValueError, match="needs 16x16"):
        project(gen, np.zeros((1, 8, 8, 3), np.float32), STEPS, Z_DIM, n_iters=1)
    with pytest.raises(ValueError, match="a saved 1-D w must be given a batch axis"):
        project(gen, u8, STEPS, Z_DIM, n_iters=1, w_init=torch.zeros(32))
    with pytest.raises(ValueError, match=r"\(batch, steps, style_dim\)"):
        project(gen, u8, STEPS, Z_DIM, n_iters=1, w_plus=True, w_init=torch.zeros(1, 32))


# -- SeFa and edit sheets ---------------------------------------------------------


@pytest.mark.parametrize("stages,trained", [(None, 2), ([1, 2], None), (None, None)])
def test_sefa_directions_match_jax(models, stages, trained):
    from byogan_tpu.editing import sefa_directions as jax_sefa
    from byogan_tpu.editing import style_projection_matrix as jax_matrix

    _, params, _, gen, _ = models
    np.testing.assert_array_equal(
        style_projection_matrix(gen.state_dict(), stages, trained), jax_matrix(params, stages, trained)
    )
    want_d, want_v = jax_sefa(params, k=5, stages=stages, trained_stages=trained)
    got_d, got_v = sefa_directions(gen.state_dict(), k=5, stages=stages, trained_stages=trained)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4)
    dots = np.abs(np.sum(got_d * want_d, axis=1))
    assert dots.min() >= 1 - 1e-5, dots
    with pytest.raises(ValueError, match="no stages selected"):
        style_projection_matrix(gen.state_dict(), stages=[7])


@pytest.mark.parametrize("w_plus,edit_stages,alpha", [(False, None, None), (True, None, ALPHA), (False, (0, 2), ALPHA),
                                                      (True, (1,), None)])
def test_edit_sheet_matches_jax(models, w_plus, edit_stages, alpha):
    from byogan_tpu.editing import edit_sheet as jax_sheet

    jgen, params, _, gen, _ = models
    r = np.random.default_rng(11)
    w = r.standard_normal((2, STEPS, 32) if w_plus else (2, 32)).astype(np.float32)
    direction, _ = sefa_directions(gen.state_dict(), k=1, trained_stages=STEPS)
    coeffs = [-2.0, 0.0, 1.5]
    want = jax_sheet(jgen, {"params": params}, jnp.asarray(w), direction[0], STEPS, coeffs, noise_seed=6,
                     edit_stages=edit_stages, alpha=alpha)
    got = edit_sheet(gen, w, direction[0], STEPS, coeffs, edit_stages=edit_stages, alpha=alpha,
                     noise=[_t(n) for n in _jax_noise(6, 1)])
    assert got.shape == (6, RES, RES, 3)
    assert_rel(got.numpy(), np.asarray(want), what="sheet")
    with pytest.raises(ValueError, match="outside"):
        edit_sheet(gen, w, direction[0], STEPS, coeffs, edit_stages=(STEPS,))


def test_edit_sheet_rejects_a_wplus_latent_of_other_depth(models):
    gen = models[3]
    with pytest.raises(ValueError, match="stage rows"):
        edit_sheet(gen, np.zeros((1, STEPS + 1, 32), np.float32), np.ones(32), STEPS, [0.0])


# -- interpolation ----------------------------------------------------------------


@pytest.mark.parametrize("w_space", [False, True])
def test_interpolation_frames_match_jax_cli(models, tmp_path, w_space):
    """JAX's CLI with its latents and noise replaced by given arrays and
    its frame writer recording the float frames it would save."""
    from byogan_tpu.cli import interpolate as jax_cli
    from byogan_tpu.core import grids as jax_grids
    from byogan_tpu.core import random as jax_random
    from byogan_tpu.train import checkpoint as jax_ckpt

    jgen, params, ema, gen, path = models
    r = np.random.default_rng(12)
    z = np.clip(r.standard_normal((3, Z_DIM)), -0.7, 0.7).astype(np.float32)
    noise = [r.standard_normal((1, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32) for i in range(STEPS)]
    saved = []
    jax_save = {"gen_params": params, "gen_ema": ema, "step": STEPS, "alpha": ALPHA, "model": SPEC}
    with mock.patch.object(jax_ckpt, "load_checkpoint", lambda _: dict(jax_save)), \
            mock.patch.object(jax_random, "truncated_noise", lambda *a, **k: jnp.asarray(z)), \
            mock.patch.object(jax_random, "fixed_synthesis_noise", lambda *a, **k: [jnp.asarray(n) for n in noise]), \
            mock.patch.object(jax_grids, "save_image", lambda f, p: saved.append(np.asarray(f))):
        jax_cli.main([path, "-o", str(tmp_path), "-n", "3", "-p", "4", "-d", "cpu"] + (["--w-space"] if w_space else []))
    ends = _t(z)
    if w_space:
        with torch.no_grad():
            ends = gen.map_latent(ends)
    got = torch.cat([render_pair(gen, ends[i], ends[i + 1], [_t(n) for n in noise], STEPS, ALPHA, 4, w_space)
                     for i in range(2)])
    assert len(saved) == 8 and got.shape == (8, RES, RES, 3)
    assert_rel(got.numpy(), np.stack(saved), what="frames")


# -- the CLIs ---------------------------------------------------------------------


def test_project_edit_and_interpolate_clis_write_their_files(models, tmp_path, capsys):
    from byogan_tpu_torch.cli.edit import main as edit_main
    from byogan_tpu_torch.cli.interpolate import main as interpolate_main
    from byogan_tpu_torch.cli.project import main as project_main
    from byogan_tpu_torch.data.png import read_png
    from byogan_tpu_torch.serve import encode_png

    path = models[4]
    r = np.random.default_rng(13)
    for name, size in (("a", RES), ("b", 24)):  # b needs the resize
        (tmp_path / f"{name}.png").write_bytes(encode_png(r.integers(0, 256, (size, size, 3), dtype=np.uint8)))
    out = tmp_path / "proj"
    project_main([path, str(tmp_path / "a.png"), str(tmp_path / "b.png"), "-o", str(out), "--iters", "3", "-d", "cpu"])
    assert sorted(os.listdir(out)) == ["a-proj.png", "a-w.npy", "b-proj.png", "b-w.npy"]
    assert read_png(str(out / "b-proj.png")).shape == (RES, RES, 3) and np.load(out / "a-w.npy").shape == (32,)
    assert "projected 2 image(s)" in capsys.readouterr().out
    project_main([path, str(tmp_path / "a.png"), "-o", str(tmp_path / "plus"), "--iters", "2", "--w-plus", "--ema",
                  "-d", "cpu"])
    assert np.load(tmp_path / "plus" / "a-w.npy").shape == (STEPS, 32)

    cell = RES + 2
    for extra, rows in (([], 3), (["--w", str(out / "a-w.npy")], 1), (["--w", str(tmp_path / "plus" / "a-w.npy")], 1),
                        (["--stages", "0,1", "--ema", "-r", "2"], 2)):
        sheet = tmp_path / "sheet.png"
        edit_main([path, "-o", str(sheet), "--steps", "5", "-d", "cpu"] + extra)
        assert read_png(str(sheet)).shape == (rows * cell + 2, 5 * cell + 2, 3), extra
    with pytest.raises(SystemExit, match="untrained"):
        edit_main([path, "-o", str(sheet), "--stages", "3", "-d", "cpu"])

    frames = tmp_path / "frames"
    interpolate_main([path, "-o", str(frames), "-n", "3", "-p", "4", "--ema", "--w-space", "-d", "cpu"])
    assert sorted(os.listdir(frames), key=lambda f: int(f[6:-4])) == [f"image_{e}.png" for e in range(1, 9)]
    assert "wrote 8 frames" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["project", "edit", "interpolate", "evaluate"])
def test_clis_raise_without_a_gpu_unless_asked_for_the_cpu(models, tmp_path, cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    main = importlib.import_module(f"byogan_tpu_torch.cli.{cli}").main
    args = {"project": [str(tmp_path / "x.png")], "evaluate": [str(tmp_path)]}.get(cli, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([models[4]] + args)
