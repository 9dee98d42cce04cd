"""The port's data axis (``byogan_tpu_torch/parallel``) against the JAX
package, on the CPU.

Two ranks of gloo processes (``torch_port_dist``, spawned once for the
module over a file store, so xdist workers never share a port) run the
port; the parent runs JAX on the global batch.  JAX's own tests hold its
data-sharded step equal to its single-device step
(tests/test_parallel.py:128-150), so the ranks are held against JAX's
single-device step with JAX's draws replayed, each rank keeping its rows.
Tolerances as tests/test_torch_port_train.py: 2e-4 relative to each
tensor's max for layers, losses and gradients; parameters after whole
steps within 2*lr and 99.9% of entries within 1e-5; frames within 1 LSB.
The ranks' parameters must be bit-equal to each other.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist
from byogan_tpu_torch.compat.torch_ckpt import critic_state_from_jax, generator_state_from_jax
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.parallel import mesh as port_mesh
from byogan_tpu_torch.serve import Sampler
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.loop import build_state, train
from tests.conftest import SMALL_CRITIC_BLOCKS, SMALL_CRITIC_FROM_RGB, SMALL_GEN_CHANNELS, build, small_config
from tests.test_torch_port_regularizers import _regularizer_draws
from tests.test_torch_port_serve import ALPHA, STEPS as SERVE_STEPS, checkpoint  # noqa: F401 (a fixture)
from tests.test_torch_port_train import BATCH, STEPS, _assert_params, _jax_draws, _loop_config, _t, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
C_LAMBDA = 10.0
STEP_CASES = {
    "r1": (dict(), True),
    "ada_plr": (dict(plr_weight=2.0, plr_interval=2, ada_target=0.6, aug_p=0.5), True),
}
SIGNAL_ITER = 5  # rank 1 receives SIGTERM after this iteration of the 8


def _critic_params():
    from tests.conftest import small_critic

    params = jax.jit(lambda k: small_critic().init(k, jnp.zeros((4, 4, 4, 3)), steps=1))(jax.random.PRNGKey(3))
    r = np.random.default_rng(4)
    return jax.tree_util.tree_map_with_path(  # nonzero biases, so their paths show
        lambda p, v: (0.1 * r.standard_normal(v.shape)).astype(np.float32) if p[-1].key == "bias" else np.asarray(v),
        params["params"],
    )


def _stddev_cases(critic_params):
    """Per global batch (8: G 4, M 2; 6: the whole batch as the group): the
    JAX layer's output and input gradient, and JAX's R1 critic gradient."""
    from byogan_tpu.models.layers import MinibatchStdDev as JaxStd
    from byogan_tpu.train import losses as jl
    from tests.conftest import small_critic

    cases, want = [], []
    for b in (8, 6):
        r = np.random.default_rng(b)
        x = r.standard_normal((b, 4, 4, 5)).astype(np.float32)
        real, fake = (r.standard_normal((b, 4, 4, 3)).astype(np.float32) for _ in range(2))
        layer = JaxStd()
        y, vjp = jax.vjp(lambda x_: layer.apply({}, x_), jnp.asarray(x))
        (gx,) = vjp(jnp.cos(y) - y * jnp.sin(y))  # d/dy of sum(y cos y)
        jcritic = small_critic()

        def jloss(cp):
            crit = lambda im: jcritic.apply({"params": cp}, im, steps=1)  # noqa: E731
            return jl.critic_r1_loss(crit, jnp.asarray(real), jnp.asarray(fake), C_LAMBDA)[0]

        grads = critic_state_from_jax(jax.jit(jax.grad(jloss))(critic_params))
        cases.append(dict(
            x=_t(x).permute(0, 3, 1, 2).contiguous(), critic_state=critic_state_from_jax(critic_params),
            critic_tables=(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS), real=_t(real), fake=_t(fake),
            c_lambda=C_LAMBDA,
        ))
        want.append((np.asarray(y), np.asarray(gx), grads))
    return cases, want


def _step_cases(small):
    """Per config: the initial port state, two iterations' global batch and
    JAX's draws, and JAX's metrics and state after each."""
    from byogan_tpu.train.steps import make_train_step

    jgen, jcritic, jstate0 = small
    cases, want = [], []
    for knobs, fade in STEP_CASES.values():
        jcfg = small_config(**knobs)
        jstate = jstate0.replace(
            aug_p=jnp.float32(jcfg.aug_p) if jcfg.use_aug else None,
            rt_ema=jnp.float32(0.0) if jcfg.ada_target > 0 else None,
            pl_ema=jnp.float32(0.0) if jcfg.plr_weight > 0 else None,
        )
        jstep = make_train_step(jgen, jcritic, jcfg, steps=STEPS, batch=BATCH, fade_in=10.0,
                                critic_fade=(fade,), gen_fade=fade, donate=False)
        case = dict(
            config=dict(dataclasses.asdict(jcfg), data_axis=WORLD),
            gen_tables=((SMALL_GEN_CHANNELS,), dict(style_dim=32, mapping_depth=2, z_dim=32)),
            critic_tables=(SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS),
            gen_state=generator_state_from_jax(jstate.gen_params),
            critic_state=critic_state_from_jax(jstate.critic_params),
            stage=STEPS, batch=BATCH, fade_in=10.0, fade=fade, iterations=[],
        )
        metrics = []
        for i in range(2):
            real = np.random.default_rng(9 + i).integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
            if jcfg.use_aug or jcfg.plr_weight > 0:
                draws = _regularizer_draws(jstate.rng, jcfg, i, 8)
            else:
                draws = _jax_draws(jstate.rng, jcfg, STEPS)[0]
            case["iterations"].append((torch.from_numpy(real), draws))
            jstate, jm = jstep(jstate, jnp.asarray(real))
            metrics.append({k: float(v) for k, v in jm.items()})
        cases.append(case)
        want.append((metrics, jstate))
    return cases, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two gloo ranks for the module's cases: the minibatch
    stddev, whole steps, and ``train`` with SIGTERM on rank 1."""
    small = build(small_config())
    stddev, stddev_want = _stddev_cases(_critic_params())
    step_cases, step_want = _step_cases(small)
    tmp = tmp_path_factory.mktemp("dp")
    root = write_prepared_dataset(str(tmp / "data"), 8, 2, seed=2)
    train_cfg = dataclasses.asdict(_loop_config(tmp / "dp", root, data_axis=WORLD))
    out = torch_port_dist.run(WORLD, str(tmp), dict(
        stddev=stddev, steps=step_cases,
        train=dict(config=train_cfg, signal_rank=1, signal_iter=SIGNAL_ITER),
    ))
    return dict(out=out, stddev=(stddev, stddev_want), steps=step_want, tmp=tmp, root=root)


def _bit_equal(a: dict, b: dict, what: str):
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what} {k}: the ranks differ"


def test_agree_is_any_rank_s_flag(ranks):
    assert [o["agree"] for o in ranks["out"]] == [(True, False)] * WORLD


def test_minibatch_stddev_over_two_ranks_matches_jax_on_the_global_batch(ranks):
    """Forward, input gradient and R1's parameter gradient (a double
    backward through ``AllReduceSum``) at B=8, G=4 and at B=6, where the
    group is the whole global batch."""
    cases, want = ranks["stddev"]
    for i, (case, (y, gx, grads)) in enumerate(zip(cases, want)):
        b = case["x"].shape[0]
        got = [o["stddev"][i] for o in ranks["out"]]
        y_got = torch.cat([g["y"] for g in got]).permute(0, 2, 3, 1).numpy()
        gx_got = torch.cat([g["gx"] for g in got]).permute(0, 2, 3, 1).numpy()
        assert y_got.shape == (b, 4, 4, 6)
        assert_rel(y_got, y, what=f"B={b} forward")
        assert_rel(gx_got, gx, what=f"B={b} input gradient")
        _bit_equal(got[0]["grads"], got[1]["grads"], f"B={b} R1 gradient")
        for n, w in grads.items():
            assert_rel(got[0]["grads"][n].numpy(), w.numpy(), what=f"B={b} R1 gradient {n}")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_rank_steps_match_jax_single_device_step(ranks, case):
    """Two whole steps over two ranks, from a state broadcast from rank 0
    (rank 1 starts from other weights and counters), on JAX's draws split
    by rows: every metric, aug_p, rt_ema and pl_ema as JAX's single-device
    step on the global batch; the ranks' nets bit-equal."""
    i = list(STEP_CASES).index(case)
    metrics, jstate = ranks["steps"][i]
    got = [o["steps"][i] for o in ranks["out"]]
    for r in got:
        assert r["counters"] == (2, 2 * BATCH)
        for it, (pm, jm) in enumerate(zip(r["metrics"], metrics)):
            assert set(pm) == set(jm), (sorted(pm), sorted(jm))
            for k in jm:
                assert_rel(pm[k], jm[k], what=f"iteration {it} {k}")
        for k in ("aug_p", "rt_ema", "pl_ema"):
            assert (k in r) == (getattr(jstate, k) is not None), k
            if k in r:
                assert_rel(r[k], float(getattr(jstate, k)), what=k)
    if case == "ada_plr":
        assert got[0]["metrics"][0]["pl_penalty"] > 0 and got[0]["metrics"][1]["pl_penalty"] == 0
    for net in ("gen", "critic"):
        _bit_equal(got[0][net], got[1][net], net)
    _assert_params(got[0]["gen"], generator_state_from_jax(jstate.gen_params))
    _assert_params(got[0]["critic"], critic_state_from_jax(jstate.critic_params))


def _listing(d):
    return sorted(os.listdir(d))


def test_two_rank_train_writes_one_artifact_set_and_resumes_in_one_process(ranks, tmp_path):
    """``train`` over two ranks, SIGTERM on rank 1 alone after iteration 5:
    both stop there, rank 0 writes one checkpoint and one metrics file,
    whose losses are the one-process run's; the checkpoint resumes in one
    process to the end of the one-process run."""
    root, dp = ranks["root"], ranks["tmp"] / "dp"
    got = [o["train"] for o in ranks["out"]]
    assert [(g["iters"], g["im_count"]) for g in got] == [(SIGNAL_ITER, 4)] * WORLD
    for net in ("gen", "critic"):
        _bit_equal(got[0][net], got[1][net], net)
    one = _loop_config(tmp_path / "one", root)
    part = train(one, max_iters=SIGNAL_ITER, device="cpu")
    assert _listing(dp / "ck") == _listing(tmp_path / "one" / "ck") == [f"chk-{SIGNAL_ITER}.pth"]
    assert _listing(dp / "out") == _listing(tmp_path / "one" / "out") == ["metrics.jsonl", "s-3.png"]
    read = lambda d: [json.loads(line) for line in open(d / "metrics.jsonl")]  # noqa: E731
    dp_log, one_log = read(dp / "out"), read(tmp_path / "one" / "out")
    assert [r["iter"] for r in dp_log] == [r["iter"] for r in one_log] == [2, 4]
    for a, b in zip(dp_log, one_log):
        for k in ("c_loss", "g_loss", "rt"):
            assert_rel(a[k], b[k], what=f"iter {a['iter']} {k}")
    _assert_params(got[0]["gen"], part.gen.state_dict())
    full = train(_loop_config(tmp_path / "full", root), device="cpu")
    resumed = train(_loop_config(dp, root), checkpoint=str(dp / "ck" / f"chk-{SIGNAL_ITER}.pth"), device="cpu")
    assert (resumed.iters, resumed.stage, resumed.im_count) == (full.iters, full.stage, full.im_count) == (8, 2, 16)
    _assert_params(resumed.gen.state_dict(), full.gen.state_dict())
    _assert_params(resumed.critic.state_dict(), full.critic.state_dict())


def test_world_one_mesh_step_is_the_step_without_a_mesh():
    """A one-process group (gloo on the CPU): the step over the mesh and
    the step without one give the same bits."""
    cfg = PortConfig(noise_size=16, compute_dtype="float32", channel_divisor=32, mapping_depth=2,
                     batch_progression=(4, 4), epoch_progression=(1, 1), ada_target=0.6, plr_weight=2.0,
                     plr_interval=1)
    real = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8))
    states = [build_state(cfg, torch.device("cpu")) for _ in range(2)]
    mesh = port_mesh.make_mesh(1, device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        port_mesh.shard_train_state(states[1], mesh)
        outs = [port_steps.make_train_step(cfg, 2, 4, 10.0, (True,), True, mesh=m)(s, real)
                for s, m in zip(states, (None, mesh))]
    finally:
        torch.distributed.destroy_process_group()
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for net in ("gen", "critic"):
        _bit_equal(getattr(states[0], net).state_dict(), getattr(states[1], net).state_dict(), net)


def test_train_in_a_one_process_group_is_train_without_one(tmp_path, capsys):
    """``train`` inside a one-process group (a torchrun of one process)
    runs the step without a mesh: the same bits as outside any group."""
    root = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=2)
    alone = train(_loop_config(tmp_path / "a", root), max_iters=3, device="cpu")
    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        grouped = train(_loop_config(tmp_path / "b", root), max_iters=3, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    out = capsys.readouterr().out
    assert "process group: world 1 (gloo), no mesh" in out and "mesh: data" not in out
    assert grouped.iters == alone.iters == 3
    for net in ("gen", "critic"):
        _bit_equal(getattr(alone, net).state_dict(), getattr(grouped, net).state_dict(), net)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_rank_slices_match_jax_and_concatenate_to_the_batch(tmp_path, count):
    from byogan_tpu.data import pipeline as jax_pipe

    root = write_prepared_dataset(str(tmp_path / "data"), 12, 1, seed=4)
    jds, pds = jax_pipe.open_stage_dataset(root, 1), port_pipe.open_stage_dataset(root, 1)
    whole = list(port_pipe.make_stage_loader(pds, 4, seed=7, skip_batches=1))
    parts = []
    for i in range(count):
        want = list(jax_pipe.make_stage_loader(jds, 4, seed=7, workers=1, skip_batches=1, device_normalize=True,
                                               process_index=i, process_count=count))
        got = list(port_pipe.make_stage_loader(pds, 4, seed=7, skip_batches=1, process_index=i,
                                               process_count=count))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (4 // count, 4, 4, 3)
            np.testing.assert_array_equal(g, w)
        parts.append(got)
    for b, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b] for p in parts]), batch)
    with pytest.raises(ValueError, match="not divisible by process_count 3"):
        next(port_pipe.make_stage_loader(pds, 4, process_count=3))


def test_sampler_over_two_devices_matches_one_and_jax(checkpoint):  # noqa: F811
    path, jgen, params = checkpoint
    one = Sampler(path, batch=4, dtype="float32", device="cpu", seed=3)
    two = Sampler(path, batch=4, dtype="float32", devices=["cpu", "cpu"], seed=3)
    assert two.generator is not two._replicas[1] and len(two._replicas) == 2
    z, noise = one.draw()
    z2, noise2 = two.draw()
    assert torch.equal(z, z2) and all(torch.equal(a, b) for a, b in zip(noise, noise2))
    img = jgen.apply({"params": params}, jnp.asarray(z.numpy()), [jnp.asarray(n.numpy()) for n in noise],
                     steps=SERVE_STEPS, alpha=jnp.float32(ALPHA))
    want = np.asarray(jnp.clip(img.astype(jnp.float32) * 255.0 + 0.5, 0, 255).astype(jnp.uint8))
    got = two.render(z, noise).numpy()
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1  # 1 LSB
    np.testing.assert_array_equal(got, one.render(z, noise).numpy())
    np.testing.assert_array_equal(two.sample(6), one.sample(6))
    np.testing.assert_array_equal(two.style_mix(4, 1), one.style_mix(4, 1))
    with pytest.raises(ValueError, match="does not split over 3 devices"):
        Sampler(path, batch=4, devices=["cpu"] * 3)


def test_config_and_mesh_checks(tmp_path, monkeypatch):
    assert PortConfig(data_axis=2).data_axis == 2
    assert PortConfig(model_axis=2).model_axis == 2  # the model axis: tests/test_torch_port_tensor_parallel.py
    with pytest.raises(ValueError, match="model_axis must be >= 1, got 1, 0"):
        PortConfig(model_axis=0)
    with pytest.raises(ValueError, match="data_axis=2 needs 2 processes"):
        port_mesh.make_mesh(2, device="cpu")
    root = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=2)
    with pytest.raises(ValueError, match=r"batch_progression entries \[\(1, 4\), \(2, 4\)\] .* data-parallel axis \(3\)"):
        train(_loop_config(tmp_path, root, data_axis=3), device="cpu")
    for k in port_mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs torchrun's environment"):
        port_mesh.init_distributed(device="cpu")
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card of its own"):
        port_mesh.init_distributed()
    assert not torch.distributed.is_initialized()


def test_cli_trains_over_two_gloo_ranks_under_torchrun(tmp_path):
    root = write_prepared_dataset(str(tmp_path / "data"), 4, 1, seed=3)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        "[tiny]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 32\n"
        "mapping_depth = 2\nbatch_progression = 4\nepoch_progression = 3\ndata_axis = 2\nrefresh_stat_step = 1\n"
        f"checkpoint_dir = {tmp_path / 'ck'}\noutput_dir = {tmp_path / 'out'}\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "byogan_tpu_torch.cli.main", "tiny", "--config-file", str(cfg), "-d", "cpu", "--distributed",
         "--max-iters", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("mesh: data 2 (gloo)") == 1
    assert _listing(tmp_path / "ck") == ["chk-2.pth"]
    assert [json.loads(line)["iter"] for line in open(tmp_path / "out" / "metrics.jsonl")] == [1, 2]
