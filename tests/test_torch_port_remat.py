"""The port's rematerialization and profiler traces, on the CPU.

Remat (``TrainConfig.remat``/``remat_progression``, ``steps.maybe_remat``)
recomputes activations in the backward instead of keeping them, so a remat
step must equal the same step without it: on the CPU the recompute runs
the same ops on the same inputs, so within 1e-6 (the same bits in
practice).  Against the JAX package's remat step (``jax.checkpoint``) with
its own draws replayed, as tests/test_train_step.py:393, 424 hold JAX's
remat: 2e-4 relative, as tests/test_torch_port_train.py holds whole steps.
Small models (the conftest tables), f32.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.compat.torch_ckpt import critic_state_from_jax, generator_state_from_jax
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.ops import styleconv as port_styleconv
from byogan_tpu_torch.profiling import annotate, step_timer, trace_if
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.config import config_from_mapping, load_ini_config
from byogan_tpu_torch.train.loop import build_state
from tests.conftest import build, small_config
from tests.test_torch_port_train import BATCH, STEPS, _assert_params, _jax_draws, _port_state, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_jax():
    return build(small_config())


@pytest.fixture
def counted_forwards(monkeypatch):
    """Counts the synthesis convs' autograd forwards (K1 with residuals on
    the card): a remat step runs the generator phase's twice."""
    calls = []
    real = port_styleconv.StyleConvFunction.forward

    def forward(ctx, *args):
        calls.append(1)
        return real(ctx, *args)

    monkeypatch.setattr(port_styleconv.StyleConvFunction, "forward", staticmethod(forward))
    return calls


def _run_steps(knobs, n_steps=2):
    cfg = PortConfig(noise_size=16, compute_dtype="float32", channel_divisor=32, mapping_depth=2,
                     batch_progression=(4, 4, 4), epoch_progression=(1, 1, 1), **knobs)
    state = build_state(cfg, torch.device("cpu"))
    step = port_steps.make_train_step(cfg, 3, 4, 10.0, (True,), True)
    real = torch.randint(0, 256, (4, 16, 16, 3), generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    metrics = [{k: float(v) for k, v in step(state, real).items()} for _ in range(n_steps)]
    return metrics, state


@pytest.mark.parametrize(
    "knobs",
    [dict(), dict(style_mix_prob=0.9), dict(ada_target=0.6, aug_p=0.5, plr_weight=2.0, plr_interval=2)],
    ids=["default", "mixing", "ada_plr"],
)
def test_remat_step_equals_the_step_without_it(knobs, counted_forwards):
    """Two steps at stage 3 with and without remat from one initial state
    and seed: losses, regularizer metrics and weights within 1e-6.  With
    PLR the first step is penalized, so the penalty's second derivative
    runs through the recomputed synthesis.  The remat run calls the
    synthesis convs' forward once more per conv in each backward that
    recomputes: the generator phase's once a step, PLR's synthesis twice
    (for the inner gradient, and again for the parameter gradient, a
    backward of its own)."""
    (m_plain, s_plain) = _run_steps(knobs)
    plain_calls = len(counted_forwards)
    (m_remat, s_remat) = _run_steps(dict(knobs, remat=True))
    remat_calls = len(counted_forwards) - plain_calls
    convs = 5  # K1's at stage 3: one in the 4x4 block (beside K2), two in each of the others
    extra = 2 * convs + (2 * convs if "plr_weight" in knobs else 0)  # two steps; PLR's on step 0
    assert remat_calls == plain_calls + extra, (plain_calls, remat_calls)
    assert m_plain[0].keys() == m_remat[0].keys()
    for a, b in zip(m_plain, m_remat):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(a[k])), (k, a[k], b[k])
    for net in ("gen", "critic"):
        want, got = getattr(s_plain, net).state_dict(), getattr(s_remat, net).state_dict()
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)
    for k in ("aug_p", "rt_ema", "pl_ema"):
        if getattr(s_plain, k) is not None:
            assert abs(float(getattr(s_plain, k)) - float(getattr(s_remat, k))) <= 1e-6, k


@pytest.mark.parametrize(
    "knobs,fade",
    [
        (dict(remat=True), True),
        (dict(remat=True, style_mix_prob=1.0), True),
        (dict(remat_progression=(False, True, False)), False),
    ],
    ids=["remat", "remat_mixing", "remat_progression"],
)
def test_remat_steps_match_jax_remat(small_jax, knobs, fade):
    """Two stage-2 steps of the port's remat step against JAX's remat step
    (tests/test_train_step.py:393, 424), JAX's draws replayed: losses at
    2e-4, weights as ``_assert_params``."""
    from byogan_tpu.train.steps import make_train_step

    jcfg = small_config(**knobs)
    jgen, jcritic, jstate = small_jax
    assert jcfg.stage_remat(STEPS - 1)
    pcfg, pstate = _port_state(jcfg, jstate)
    assert pcfg.stage_remat(STEPS - 1) and dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    fade_in = 10.0
    jstep = make_train_step(jgen, jcritic, jcfg, steps=STEPS, batch=BATCH, fade_in=fade_in,
                            critic_fade=(fade,), gen_fade=fade, donate=False)
    pstep = port_steps.make_train_step(pcfg, STEPS, BATCH, fade_in, (fade,), fade)
    real = np.random.default_rng(12).integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
    for i in range(2):
        draws, _ = _jax_draws(jstate.rng, jcfg, STEPS)
        jstate, jm = jstep(jstate, jnp.asarray(real))
        pm = pstep(pstate, torch.from_numpy(real), draws)
        assert set(pm) == set(jm)
        for k in jm:
            assert_rel(float(pm[k]), float(jm[k]), what=f"step {i} {k}")
    _assert_params(pstate.gen.state_dict(), generator_state_from_jax(jstate.gen_params))
    _assert_params(pstate.critic.state_dict(), critic_state_from_jax(jstate.critic_params))


def test_stage_remat_parses_and_checks_as_jax():
    """tests/test_config.py:4-28 on the port."""
    c = config_from_mapping({"batch_progression": "4,4,4", "epoch_progression": "1,1,1",
                             "remat_progression": "False,True,False"})
    assert c.remat_progression == (False, True, False)
    assert [c.stage_remat(i) for i in range(3)] == [False, True, False]
    c2 = config_from_mapping({"batch_progression": "4,4", "epoch_progression": "1,1", "remat": "True"})
    assert c2.remat_progression is None and [c2.stage_remat(i) for i in range(2)] == [True, True]
    with pytest.raises(ValueError, match="remat_progression has 1 flags for 2 stages"):
        PortConfig(batch_progression=(4, 4), epoch_progression=(1, 1), remat_progression=(True,))
    assert PortConfig(model_axis=2).model_axis == 2  # the model axis is too (parallel/tensor.py)
    with pytest.raises(ValueError, match="model_axis must be >= 1, got 1, 0"):
        PortConfig(model_axis=0)
    assert PortConfig(data_axis=2).data_axis == 2  # the data axis is (parallel/mesh.py)


def test_ffhq_tpu_tuned_loads_as_in_jax():
    """``configs/example.txt [ffhq-tpu-tuned]``, the shipped schedule with
    remat at stage 7, loads field for field as JAX's ``load_ini_config``."""
    from byogan_tpu.train.config import load_ini_config as jax_load

    path = os.path.join(ROOT, "configs", "example.txt")
    want = jax_load(path, "ffhq-tpu-tuned")
    got = load_ini_config(path, "ffhq-tpu-tuned")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [got.stage_remat(i) for i in range(8)] == [want.stage_remat(i) for i in range(8)] == [False] * 6 + [True, False]


def _trace_events(trace_dir):
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_trace_if_writes_a_trace_naming_the_region(tmp_path, monkeypatch):
    sink = {}
    with trace_if(str(tmp_path / "a")), step_timer("work", sink), annotate("byogan region"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    names = _trace_events(str(tmp_path / "a"))
    assert "byogan region" in names and any("mm" in n for n in names)
    assert sink["work"] > 0
    with trace_if(None):  # no directory, no variable: nothing traced
        pass
    monkeypatch.setenv("BYOGAN_TRACE_DIR", str(tmp_path / "env"))
    with trace_if(None), annotate("from the environment"):
        torch.zeros(3).sum()
    assert "from the environment" in _trace_events(str(tmp_path / "env"))


def test_cli_trace_dir_and_remat_progression(tmp_path, counted_forwards):
    """The training CLI with ``--trace-dir`` writes a trace naming each
    iteration's region; ``remat_progression`` recomputes at its flagged
    stage only: two iterations at stage 1, two at stage 2 (remat)."""
    from byogan_tpu_torch.cli.main import main

    root = write_prepared_dataset(str(tmp_path / "data"), 4, 2, seed=3)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        "[tiny]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 32\n"
        "mapping_depth = 2\nbatch_progression = 2,2\nepoch_progression = 1,1\n"
        "remat_progression = False,True\ndisplay_step = 100\n"
        f"checkpoint_dir = {tmp_path / 'ck'}\noutput_dir = {tmp_path / 'out'}\n"
    )
    per_iteration = []
    real = port_steps.make_train_step

    def counting(config, steps, *a):
        fn = real(config, steps, *a)

        def step(state, batch, draws=None):
            before = len(counted_forwards)
            out = fn(state, batch, draws)
            per_iteration.append((steps, len(counted_forwards) - before))
            return out

        return step

    from byogan_tpu_torch.train import loop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "make_train_step", counting)
        state = main(["tiny", "--config-file", str(cfg), "-d", "cpu", "--trace-dir", str(tmp_path / "trace")])
    assert state.iters == 4
    # stage 1: one conv, forward once; stage 2: three convs, forward and recompute
    assert per_iteration == [(1, 1), (1, 1), (2, 6), (2, 6)], per_iteration
    names = _trace_events(str(tmp_path / "trace"))
    assert "train_step stage 1" in names and "train_step stage 2" in names
