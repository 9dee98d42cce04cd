"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
Pallas kernels run in interpret mode, as tests/test_pallas_ops.py runs them;
the port's wrappers take their plain PyTorch versions for CPU tensors.
tests/test_torch_port_cuda.py holds the hand-written kernels against those
plain versions on the card.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.models.factory import ModelSpec
from byogan_tpu_torch.ops import adain as port_adain
from byogan_tpu_torch.ops import styleconv as port_sc
from byogan_tpu_torch.ops import styleconv_bwd as port_bwd
from byogan_tpu_torch.ops.cardcheck import K1_CASES, K3_CASES
from byogan_tpu_torch.ops.fused import noise_lrelu_adain, noise_lrelu_adain_plain
from byogan_tpu_torch.train.config import TrainConfig
from torch_port_inputs import F32_ARGS, as_torch, epilogue_inputs, styleconv_inputs

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: float rounding only.  bf16: the JAX test's own tolerance
# (tests/test_pallas_ops.py), a few bf16 ulps at |x| ~ 4.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _k2_pallas_interpret(x, noise, w, gamma, beta, eps=1e-8):
    """The JAX K2 kernel body run through the Pallas interpreter."""
    from jax.experimental import pallas as pl

    from byogan_tpu.ops import pallas_adain as pa

    n, h, wd, c = x.shape
    hw = h * wd
    out = pl.pallas_call(
        functools.partial(pa._kernel, eps=eps),
        out_shape=jax.ShapeDtypeStruct((n, hw, c), x.dtype),
        grid=(n,),
        in_specs=[
            pl.BlockSpec((1, hw, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, hw, 1), lambda i: (i, 0, 0)),
            pl.BlockSpec(),
            pl.BlockSpec((1, 1, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, 1, c), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, hw, c), lambda i: (i, 0, 0)),
        interpret=True,
    )(x.reshape(n, hw, c), noise.reshape(n, hw, 1), w.reshape(1, c),
      gamma.reshape(n, 1, c), beta.reshape(n, 1, c))
    return out.reshape(n, h, wd, c)


def _as_jax(ins, jdt):
    return {k: jnp.asarray(v, jnp.float32 if k in F32_ARGS else jdt) for k, v in ins.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16, 24), (2, 16, 16, 8, 8)])
def test_styleconv_plain_matches_jax_pallas(monkeypatch, shape, dtype):
    from byogan_tpu.ops import pallas_styleconv as sc

    monkeypatch.setattr(sc, "_INTERPRET", True)
    jdt, tdt = DTYPES[dtype]
    ins = styleconv_inputs(*shape, seed=sum(shape))
    want = sc.styleconv_pallas(**_as_jax(ins, jdt))
    got = port_sc.styleconv(**as_torch(ins, tdt))
    assert got.dtype == tdt and got.shape == want.shape
    tol = 1e-4 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 4, 4, 32)])
def test_adain_plain_matches_jax_kernel(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    ins = epilogue_inputs(shape, seed=sum(shape))
    j = _as_jax(ins, jdt)
    want = _k2_pallas_interpret(j["x"], j["noise"], j["noise_w"], j["gamma"], j["beta"])
    got = noise_lrelu_adain(**as_torch(ins, tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


def test_adain_plain_matches_jax_lax_epilogue():
    """The plain epilogue repeats fused.py's lax casts step for step: in
    bf16 the two differ by at most one ulp (0.2*h rounds differently)."""
    from byogan_tpu.ops.fused import noise_lrelu_adain_lax

    ins = epilogue_inputs((2, 8, 8, 16), seed=7)
    want = noise_lrelu_adain_lax(**_as_jax(ins, jnp.bfloat16))
    got = noise_lrelu_adain_plain(**as_torch(ins, torch.bfloat16))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2
    )


def test_truncated_noise_bounds_moments_shape():
    g = torch.Generator().manual_seed(0)
    z = truncated_noise(g, 4000, 64, trunc=0.75)
    assert z.shape == (4000, 64) and z.dtype == torch.float32
    assert float(z.abs().max()) <= 0.75
    # N(0,1) truncated to +-0.75: mean 0, variance 1 - 2*a*phi(a)/(2*Phi(a)-1).
    a = 0.75
    phi = np.exp(-a * a / 2) / np.sqrt(2 * np.pi)
    big_phi = 0.5 * (1 + float(torch.erf(torch.tensor(a / np.sqrt(2)))))
    var = 1 - 2 * a * phi / (2 * big_phi - 1)
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - var) < 0.01
    assert truncated_noise(g, 2, 8, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_synthesis_noise_shapes_and_moments():
    g = torch.Generator().manual_seed(1)
    maps = synthesis_noise(g, 3, 5)
    assert [tuple(m.shape) for m in maps] == [(3, r, r, 1) for r in (4, 8, 16, 32, 64)]
    big = maps[-1]
    assert abs(float(big.mean())) < 0.05 and abs(float(big.std()) - 1) < 0.05
    # Same seed, same draws: the Sampler's randomness is reproducible.
    again = synthesis_noise(torch.Generator().manual_seed(1), 3, 5)
    assert all(torch.equal(a, b) for a, b in zip(maps, again))


def test_cpu_tensors_never_launch_kernels():
    before = (port_sc.styleconv_cuda.launches, port_adain.noise_lrelu_adain_cuda.launches)
    ins = styleconv_inputs(2, 8, 8, 8, 8, seed=3)
    port_sc.styleconv(**as_torch(ins, torch.float32))
    noise_lrelu_adain(**as_torch(epilogue_inputs((2, 4, 4, 8), seed=4), torch.float32))
    after = (port_sc.styleconv_cuda.launches, port_adain.noise_lrelu_adain_cuda.launches)
    assert before == after


def test_kernel_wrappers_refuse_cpu_tensors():
    ins = as_torch(styleconv_inputs(1, 4, 4, 8, 8, seed=5), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        port_sc.styleconv_cuda(**ins)
    ep = as_torch(epilogue_inputs((1, 4, 4, 8), seed=6), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        port_adain.noise_lrelu_adain_cuda(**ep)
    _, hv, mean, inv = noise_lrelu_adain_plain(**ep, with_stats=True)
    with pytest.raises(ValueError, match="CUDA"):
        port_bwd.styleconv_backward_cuda(ep["x"], hv, mean, inv, ep["gamma"], ep["noise"], ep["noise_w"])


# (n, h, w, cin, cout, forced bm): the 15 K1 launches of one pass through
# the full-width generator at batches 1, 5, 8 and 64 with the planner's own
# tiles, then the card checks' shapes and forced plans.
PLAN_CASES = [
    (n, r, r, cin, cout, None) for n in (1, 5, 8, 64) for r, cin, cout in ModelSpec().styleconv_shapes()
] + [(*shape, bm) for shape, bm in K1_CASES]


def _pixel_hits(p, n, h, w):
    """How often K1's blocks write each pixel under plan p: the kernel's
    row -> (sample, y, x) map (csrc/styleconv.cu, conv3x3_mma) over every
    tile."""
    m = np.arange(p.bm)
    hw_t = p.th * p.tw
    j, l = m // hw_t, m % hw_t
    t = np.arange(p.m_tiles)[:, None]
    if p.spt > 1:
        s0, y0, x0 = t * p.spt, 0, 0
    else:
        s0, ti = t // p.tiles_per_sample, t % p.tiles_per_sample
        y0, x0 = (ti // p.tiles_x) * p.th, (ti % p.tiles_x) * p.tw
    s, y, x, j = np.broadcast_arrays(s0 + j, y0 + l // p.tw, x0 + l % p.tw, j)
    ok = (j < p.spt) & (s < n) & (y < h) & (x < w)
    hits = np.zeros((n, h, w), np.int64)
    np.add.at(hits, (s[ok], y[ok], x[ok]), 1)
    return hits


def test_generator_has_15_styleconv_shapes():
    shapes = ModelSpec().styleconv_shapes()
    assert len(shapes) == 15 and shapes[0] == (4, 512, 512) and shapes[-1] == (512, 16, 16)
    assert all(a[2] == b[1] for a, b in zip(shapes, shapes[1:]))  # each conv feeds the next


@pytest.mark.parametrize("n,h,w,cin,cout,bm", PLAN_CASES)
def test_styleconv_tile_plan(n, h, w, cin, cout, bm):
    p = port_sc.plan_tiles(n, h, w, cin, cout) if bm is None else port_sc.bf16_plan(n, h, w, cin, cout, bm)
    assert (p.bm, p.bn) in port_sc.WARPS
    assert 0 < p.smem <= port_sc.SMEM_LIMIT and 1 <= p.stages <= port_sc.STAGES
    hw = h * w
    if hw < p.bm and p.spt > 1:  # whole samples per tile: no room for one more
        assert p.bm - p.spt * hw < hw or p.spt == n or (p.spt + 1) * (h + 2) * (w + 2) > port_sc.MAX_HALO
    if bm is None:  # the planner's own choice leaves no row idle in every tile
        assert not p.idle_rows
        assert p.spt * p.th * p.tw == p.bm or p.tiles_per_sample > 1
    # every pixel and every output channel exactly once
    assert (_pixel_hits(p, n, h, w) == 1).all()
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    # the f32 route: 256 threads of 4x4 outputs, runs of bm pixels
    f = port_sc.plan_tiles(n, h, w, cin, cout, torch.float32)
    assert (f.bm // 4) * (f.bn // 4) == 256 and f.bm * f.tiles_per_sample >= hw


def test_tile_plan_mirrors_the_kernel_source():
    """plan_tiles' tables are the ones csrc/styleconv.cu instantiates and checks."""
    import re

    src = (Path(port_sc.__file__).parent.parent / "csrc" / "styleconv.cu").read_text()
    tiles = re.findall(r"^\s*BYOGAN_TILE\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)
    assert {tuple(map(int, t[:2])): tuple(map(int, t[2:])) for t in tiles} == port_sc.WARPS
    for py, cu in (("BK", "kBK"), ("STAGES", "kStages"), ("MAX_HALO", "kMaxHalo"), ("MAX_SPT", "kMaxSpt")):
        assert re.search(rf"constexpr int {cu} = (\d+);", src).group(1) == str(getattr(port_sc, py))


# (n, hw, c): K3's 16 calls of a stage-8 iteration (the 15 synthesis convs
# and the initial block) at every batch of the default batch_progression,
# then the card tests' shapes.
K3_PLAN_CASES = [
    (n, r * r, c) for n in sorted(set(TrainConfig().batch_progression))
    for r, c in [(r, cout) for r, _, cout in ModelSpec().styleconv_shapes()] + [(4, 512)]
] + [(n, h * w, c) for n, h, w, c in K3_CASES]


@pytest.mark.parametrize("n,hw,c", K3_PLAN_CASES)
def test_backward_plan(n, hw, c):
    p = port_bwd.plan_backward(n, hw, c)
    # every channel in exactly one group of 8, a pixel's groups in one block
    assert (p.groups - 1) * port_bwd.VEC < c <= p.groups * port_bwd.VEC
    assert p.pixels == port_bwd.THREADS // p.groups
    # every pixel of a sample exactly once: block `tile` takes step st's
    # pixel q at tile*steps*pixels + st*pixels + q, below its span's end
    # (csrc/styleconv_bwd.cu, epilogue_sums and epilogue_apply)
    span = p.steps * p.pixels
    tile, st, q = np.ogrid[: p.tiles, : p.steps, : p.pixels]
    pix = tile * span + st * p.pixels + q
    hits = np.bincount(pix[pix < np.minimum((tile + 1) * span, hw)], minlength=hw)
    assert len(hits) == hw and (hits == 1).all()
    # at least 2 waves of blocks wherever the work allows, and few partials
    if n * hw * c // port_bwd.VEC >= 2 * 132 * port_bwd.THREADS:
        assert p.blocks >= 2 * 132
    assert p.blocks < 2 * port_bwd.TARGET_BLOCKS + n
    # the f32 scratch holds what the kernel indexes past dbias and dnoise_w
    # (2, C): the sums (2, N, C), then the partials part[k, s, tile, c]
    sums_end = 2 * n * c
    part_end = ((1 * n + n - 1) * p.tiles + p.tiles - 1) * c + c
    assert p.scratch_floats(c) == 2 * c + sums_end + part_end


def test_backward_plan_mirrors_the_kernel_source():
    """plan_backward's constants are the ones csrc/styleconv_bwd.cu uses."""
    import re

    src = (Path(port_bwd.__file__).parent.parent / "csrc" / "styleconv_bwd.cu").read_text()
    for py, cu in (("THREADS", "kThreads"), ("VEC", "kVec")):
        assert re.search(rf"constexpr int .*\b{cu} = (\d+)", src).group(1) == str(getattr(port_bwd, py))
    with pytest.raises(ValueError, match="channels"):
        port_bwd.plan_backward(1, 16, port_bwd.MAX_C + 1)


def test_port_imports_no_jax():
    """The port and all its submodules import without JAX or byogan_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import byogan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'byogan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax')\n"
        "       or m == 'byogan_tpu' or m.startswith('byogan_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('byogan_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15  # every submodule was imported


def test_chip_smoke_fails_without_a_gpu():
    """chip_smoke.py exits nonzero and prints no result line without a card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py")], capture_output=True, text=True,
        timeout=120, cwd=root,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "no CUDA device" in res.stderr
