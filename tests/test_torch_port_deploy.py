"""The port's serving programs and export CLI (``deploy.py``,
``cli/export.py``), the registered ops K1 and K2 become, and the seeded
synthesis noise, on the CPU.  Mirrors tests/test_deploy.py:33-180 and the
``.pth`` lane of tests/test_cli.py:107-171.

Exact comparisons: a program run on the CPU executes the same ops as the
eager generator (the registered ops take their plain versions on a CPU
tensor), so its frames equal ``Sampler.render`` on the same latents and
noise bit for bit; the ``.pth`` lane moves tensors without arithmetic, so
it equals the JAX lane's file bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from byogan_tpu_torch.cli import export as port_export
from byogan_tpu_torch.core import random as port_random
from byogan_tpu_torch.core.random import seeded_synthesis_noise
from byogan_tpu_torch.deploy import ExportedSampler, export_program
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.serve import Sampler
from byogan_tpu_torch.train.checkpoint import save_checkpoint
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import create_train_state
from torch_port_inputs import epilogue_inputs, styleconv_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ModelSpec(num_stages=3, channel_divisor=16, mapping_depth=2)
# byogan_tpu/deploy.py:127-142, with "platforms" replaced by "device" and
# "requires" added (a program runs where it was exported, and needs the ops)
SIDECAR_KEYS = {"format", "signature", "batch", "z_dim", "resolution", "steps", "alpha", "dtype", "use_ema",
                "truncation_psi", "train_truncation", "device", "requires", "model", "bytes"}


def _state(spec, ema_beta=0.0, seed=0):
    cfg = TrainConfig(noise_size=32, compute_dtype="float32", ema_beta=ema_beta)
    gen = build_generator(spec, z_dim=32, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # noise weights start at zero, which would hide the noise maps
        for n, p in gen.named_parameters():
            if "inject_noise" in n:
                p.normal_(0, 0.3, generator=torch.Generator().manual_seed(len(n)))
    state = create_train_state(cfg, gen, build_critic(spec, generator=torch.Generator().manual_seed(seed + 1)),
                               torch.device("cpu"))
    state.iters, state.stage = 1, spec.num_stages
    return state


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    return save_checkpoint(str(d), _state(SMALL), None, model_spec=SMALL)


def _program(ckpt, tmp_path, name="gen.pt2", **kw):
    out = str(tmp_path / name)
    return out, export_program(ckpt, out, **dict(dict(batch=4, dtype="float32", device="cpu"), **kw))


def test_seeded_synthesis_noise():
    """``synthesis_noise``'s shapes; a function of the seed alone (an int
    or an int64 tensor, any 64-bit value); standard normal; the integer
    hash equal to the same hash in Python integers."""
    maps = seeded_synthesis_noise(7, 3, 4)
    assert [tuple(m.shape) for m in maps] == [(3, 4 * 2**i, 4 * 2**i, 1) for i in range(4)]
    assert all(m.dtype == torch.float32 for m in maps)
    again = seeded_synthesis_noise(torch.tensor(7), 3, 4, dtype=torch.bfloat16)
    assert all(torch.equal(a.bfloat16(), b) for a, b in zip(maps, again))
    for seed in (8, -1, 2**40 + 7):
        other = seeded_synthesis_noise(seed, 3, 4)
        assert all(not torch.equal(a, b) for a, b in zip(maps, other)), seed
    z = torch.cat([m.reshape(-1) for m in seeded_synthesis_noise(3, 16, 6)])
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01 and float(z.abs().max()) < 6.0

    def hash32(x):  # lowbias32 in Python integers
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    xs = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0xDEADBEEF, 0xFFFFFFFF]
    assert port_random._hash32(torch.tensor(xs)).tolist() == [hash32(x) for x in xs]


def test_program_round_trip_equals_the_generator(ckpt, tmp_path):
    """load(save(export(...))) equals ``Sampler.render`` and the direct
    generator on the same latents and seeded noise, bit for bit; the graph
    calls the two registered ops (K1 5 times, K2 once, at 3 stages)."""
    out, meta = _program(ckpt, tmp_path)
    assert meta["resolution"] == 16 and meta["steps"] == 3 and meta["alpha"] is None
    s = ExportedSampler(out)
    assert s.in_shape == (4, 32) and s.device == torch.device("cpu")
    z = np.random.default_rng(0).standard_normal((4, 32))
    got = s(z, seed=7)
    assert got.shape == (4, 16, 16, 3) and got.dtype == np.uint8
    zt = torch.from_numpy(z).float()
    noise = seeded_synthesis_noise(7, 4, 3)
    want = Sampler(ckpt, batch=4, dtype="float32", device="cpu").render(zt, noise).numpy()
    np.testing.assert_array_equal(got, want)
    gen = build_generator(SMALL, z_dim=32)
    gen.load_state_dict(torch.load(ckpt, weights_only=False)["gen"])
    with torch.no_grad():
        direct = (gen(zt, noise, steps=3) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(got, direct)
    targets = [str(n.target) for n in torch.export.load(out).graph.nodes if n.op == "call_function"]
    assert targets.count("byogan.styleconv.default") == 5 and targets.count("byogan.noise_lrelu_adain.default") == 1


def test_program_bakes_psi_in(ckpt, tmp_path):
    """psi 0 gives every latent the mean w, so z does not matter; psi 0.7
    equals the Sampler with ``truncation_psi = 0.7``."""
    collapsed, _ = _program(ckpt, tmp_path, "psi0.pt2", truncation_psi=0.0)
    free, _ = _program(ckpt, tmp_path, "free.pt2")
    z = np.random.default_rng(1).standard_normal((4, 32))
    out_psi = ExportedSampler(collapsed)(z, seed=3)
    np.testing.assert_array_equal(out_psi, ExportedSampler(collapsed)(z[::-1], seed=3))
    assert (ExportedSampler(free)(z, seed=3) != out_psi).any()
    path, meta = _program(ckpt, tmp_path, "psi7.pt2", truncation_psi=0.7)
    assert meta["truncation_psi"] == 0.7
    want = Sampler(ckpt, batch=4, dtype="float32", device="cpu", truncation_psi=0.7).render(
        torch.from_numpy(z).float(), seeded_synthesis_noise(3, 4, 3))
    np.testing.assert_array_equal(ExportedSampler(path)(z, seed=3), want.numpy())


def test_sidecar_keys(ckpt, tmp_path):
    out, meta = _program(ckpt, tmp_path, batch=2)
    with open(out + ".json") as f:
        sidecar = json.load(f)
    assert sidecar == meta and set(sidecar) == SIDECAR_KEYS
    assert sidecar["format"] == "torch.export" and sidecar["device"] == "cpu"
    assert sidecar["signature"] == "(z: f32[batch, z_dim], seed: i64[]) -> u8[batch, res, res, 3]"
    assert sidecar["bytes"] == os.path.getsize(out) and sidecar["model"] == SMALL.to_dict()
    assert "byogan_tpu_torch.ops" in sidecar["requires"]


def test_export_cli_program(ckpt, tmp_path, capsys):
    out = str(tmp_path / "cli.pt2")
    port_export.main([ckpt, out, "--program", "--batch", "2", "--dtype", "float32", "-d", "cpu",
                      "-t", "0.6", "--psi", "0.7"])
    assert "px, device cpu" in capsys.readouterr().out
    s = ExportedSampler(out)
    assert s.meta["train_truncation"] == 0.6 and s.meta["truncation_psi"] == 0.7 and s.meta["dtype"] == "float32"
    assert s(np.zeros((2, 32), np.float32), seed=0).shape == (2, 16, 16, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_export.main([ckpt, out, "--program"])


def test_export_ema_requires_ema_weights(ckpt, tmp_path):
    with pytest.raises(ValueError, match="no EMA weights"):
        _program(ckpt, tmp_path, use_ema=True)
    with pytest.raises(SystemExit, match="no EMA"):
        port_export.main([ckpt, str(tmp_path / "x.pth"), "--ema"])


def test_exported_sampler_validates_z_shape(ckpt, tmp_path):
    out, _ = _program(ckpt, tmp_path)
    s = ExportedSampler(out)
    with pytest.raises(ValueError, match=r"\(4, 32\)"):
        s(np.zeros((3, 32), np.float32))
    with pytest.raises(ValueError, match="traced"):
        s(np.zeros((4, 16), np.float32))


def test_exported_sampler_sample_z_matches_training_distribution(ckpt, tmp_path):
    out, _ = _program(ckpt, tmp_path, batch=8, truncation=0.5)
    s = ExportedSampler(out)
    assert s.meta["train_truncation"] == 0.5
    z = s.sample_z(seed=11)
    assert z.shape == s.in_shape and z.dtype == np.float32
    assert np.abs(z).max() <= 0.5 + 1e-6 and z.std() > 0.2
    np.testing.assert_array_equal(z, s.sample_z(seed=11))
    assert s(z, seed=1).shape[0] == 8


def test_program_loads_with_the_ops_alone(ckpt, tmp_path):
    """A fresh process loads the program with ``byogan_tpu_torch.ops``
    imported and no model code, checkpoint or deploy module; without the
    ops it cannot (the program calls them)."""
    out, _ = _program(ckpt, tmp_path, batch=2)
    code = f"""
import sys, torch
try:
    torch.export.load({out!r})
    sys.exit("loaded without the ops")
except Exception:
    pass
import byogan_tpu_torch.ops
ep = torch.export.load({out!r})
frames = ep.module()(torch.zeros((2, 32)), torch.tensor(0))
assert frames.shape == (2, 16, 16, 3) and frames.dtype == torch.uint8, frames.shape
loaded = sorted(m for m in sys.modules if m.startswith("byogan"))
assert all(m.startswith("byogan_tpu_torch.ops") or m == "byogan_tpu_torch" for m in loaded), loaded
print("LOADED_WITH_THE_OPS")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert "LOADED_WITH_THE_OPS" in proc.stdout, proc.stdout[-2000:] + proc.stderr[-2000:]


def test_pth_lane_equals_jax_lane(tmp_path):
    """The default lane on a full-size checkpoint of the port against the
    JAX package's ``cli/export.py`` on the same file (read through its
    ``compat`` converters): the same keys, every tensor bit-equal, the
    same logical fields."""
    import jax

    from byogan_tpu.cli import export as jax_export

    state = _state(ModelSpec(), seed=3)
    state.iters, state.im_count, state.stage, state.epoch = 5, 25, 2, 1
    ckpt = save_checkpoint(str(tmp_path), state, 0.25, model_spec=ModelSpec())
    jax.config.update("jax_platforms", "cpu")
    jax_export.main([ckpt, str(tmp_path / "jax.pth")])
    port_export.main([ckpt, str(tmp_path / "port.pth")])
    want = torch.load(tmp_path / "jax.pth", weights_only=False)
    got = torch.load(tmp_path / "port.pth", weights_only=False)
    assert list(got) == list(want) == ["gen", "critic", "iter", "im_count", "step", "epoch", "alpha"]
    for net in ("gen", "critic"):
        assert set(got[net]) == set(want[net]) and all(k.startswith("module.") for k in got[net])
        for k, v in want[net].items():
            assert got[net][k].dtype == v.dtype and torch.equal(got[net][k], v), k
    assert [got[k] for k in list(got)[2:]] == [want[k] for k in list(want)[2:]] == [5, 25, 2, 1, 0.25]


def test_pth_lane_ema_and_reference_shape(ckpt, tmp_path):
    state = _state(ModelSpec(), ema_beta=0.9)
    with torch.no_grad():
        for p in state.gen_ema.parameters():
            p.add_(1.0)
    path = save_checkpoint(str(tmp_path), state, None, model_spec=ModelSpec())
    port_export.main([path, str(tmp_path / "ema.pth"), "--ema"])
    got = torch.load(tmp_path / "ema.pth", weights_only=False)["gen"]
    for k, v in state.gen_ema.state_dict().items():
        assert torch.equal(got[f"module.{k}"], v), k
    with pytest.raises(SystemExit, match="not the reference shape"):
        port_export.main([ckpt, str(tmp_path / "small.pth")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["styleconv", "noise_lrelu_adain"])
def test_registered_ops_pass_opcheck(op, dtype):
    """``torch.library.opcheck``: schema, fake (meta) kernel, autograd
    registration and tracing, on CPU tensors (the plain versions)."""
    if op == "styleconv":
        ins = styleconv_inputs(2, 8, 8, 8, 12, seed=1)
        args = [torch.from_numpy(ins[k]) for k in ("x", "weight", "bias", "noise", "noise_w", "gamma", "beta")]
        keep_f32 = (2, 4)  # bias and noise_w stay f32
    else:
        ins = epilogue_inputs((2, 4, 4, 16), seed=2)
        args = [torch.from_numpy(ins[k]) for k in ("x", "noise", "noise_w", "gamma", "beta")]
        keep_f32 = (2,)
    args = [a if i in keep_f32 else a.to(dtype) for i, a in enumerate(args)]
    result = torch.library.opcheck(getattr(torch.ops.byogan, op).default, (*args, 1e-8))
    assert all(v == "SUCCESS" for v in result.values()), result
