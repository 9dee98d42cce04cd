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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.ops import adain as port_adain
from byogan_tpu_torch.ops import styleconv as port_sc
from byogan_tpu_torch.ops.fused import noise_lrelu_adain, noise_lrelu_adain_plain
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


def test_block_m_tiles_fill_256_threads():
    for cout in (16, 32, 64, 512):
        bm = port_sc.block_m(cout)
        assert (bm // 4) * (4096 // bm // 4) == 256


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
