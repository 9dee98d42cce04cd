"""The port's model axis (``byogan_tpu_torch/parallel/tensor.py``) against
the JAX package, on the CPU.

Four gloo processes (``torch_port_tp_dist``, spawned once for the module
over a file store, so xdist workers never share a port) form a data 2 x
model 2 mesh and run the port with the model axis sharding features at
least 32 wide, as tests/test_parallel.py:86 lowers JAX's threshold for the
small models.  The parent runs JAX's own (2, 2)-mesh step and the port's
one-process step on the same inputs.  Tolerances: the port's against JAX
as tests/test_torch_port_train.py (2e-4 relative to each tensor's max for
layers and losses; parameters after whole steps within 2*lr and 99.9% of
entries within 1e-5); the port's mesh against its one process at JAX's
own bars for its mesh (tests/test_parallel.py:106-125: losses rtol 2e-5,
parameters rtol 2e-3, atol 1e-5).  The layers against the full layer at
2e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tp_dist as tp_dist
from byogan_tpu_torch.compat.torch_ckpt import (
    critic_key_map,
    critic_state_from_jax,
    generator_key_map,
    generator_state_from_jax,
)
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.models.critic import Critic as PortCritic
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.models.generator import Generator as PortGenerator
from byogan_tpu_torch.parallel import mesh as port_mesh
from byogan_tpu_torch.parallel.tensor import shard_module_, shard_state_dict, sharding_for_param
from byogan_tpu_torch.train import steps as port_steps
from byogan_tpu_torch.train.config import TrainConfig as PortConfig
from byogan_tpu_torch.train.loop import check_data_axis, train
from byogan_tpu_torch.train.state import create_train_state
from tests.conftest import SMALL_CRITIC_BLOCKS, SMALL_CRITIC_FROM_RGB, SMALL_GEN_CHANNELS, build, small_config
from tests.test_torch_port_regularizers import _regularizer_draws
from tests.test_torch_port_train import BATCH, STEPS, _assert_params, _jax_draws, _t, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL, TP_MIN = tp_dist.MODEL, tp_dist.TP_MIN
GEN_TABLES = ((SMALL_GEN_CHANNELS,), dict(style_dim=32, mapping_depth=2, z_dim=32))
CRITIC_TABLES = ((SMALL_CRITIC_FROM_RGB, SMALL_CRITIC_BLOCKS), {})
REG_KNOBS = dict(plr_weight=2.0, plr_interval=2, ada_target=0.6, aug_p=0.5)
# name: (knobs, fade, iterations); EMA on, as tests/test_parallel.py:81 has it
STEP_CASES = {
    "fade": (dict(), True, 2),
    "no_fade": (dict(), False, 2),
    "ada_plr": (REG_KNOBS, True, 1),
}
TRAIN_ITERS = 5  # of the 8 of two stages


def _loop_config(tmp_path, root, **kw):
    """Two stages of 8 px at channel_divisor 16, whose 32-wide layers the
    workers' threshold shards."""
    return PortConfig(
        data=root, noise_size=16, compute_dtype="float32", batch_progression=(4, 4),
        epoch_progression=(2, 2), channel_divisor=16, display_step=3,
        checkpoint_step=100, refresh_stat_step=2, fade_percentage=0.5,
        checkpoint_dir=str(tmp_path / "ck"), output_dir=str(tmp_path / "out"), **kw,
    )


def _seeded(net, seed):
    """``net`` with its zero-initialised biases and noise weights drawn, so
    that their gradients and blocks show."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias") or "inject_noise" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _layer_cases():
    """Per layer kind: the worker's case and the full layer's forward,
    input gradients and parameter gradients (``layer_case``'s loss)."""
    gen = _seeded(PortGenerator(*GEN_TABLES[0], **GEN_TABLES[1]), 1)
    critic = _seeded(PortCritic(*CRITIC_TABLES[0]), 2)
    r = np.random.default_rng(3)

    def a(*shape):
        return _t(r.standard_normal(shape))

    kinds = [  # (net, layer, inputs, wrt)
        ("gen", "to_w_noise.0.layers.0.0", dict(x=a(3, 32)), ("x",)),  # mapping: weight and bias sharded
        ("gen", "gen_blocks.0.conv_1.adain", dict(style=a(3, 32)), ("style",)),  # AdaIN, gathered [gamma; beta]
        ("gen", "gen_blocks.0.conv_1", dict(x=None, style=a(3, 32), noise=a(3, 4, 4, 1)), ("style",)),  # K2, 4x4
        ("gen", "gen_blocks.0.conv_2", dict(x=a(3, 4, 4, 64), style=a(3, 32), noise=a(3, 4, 4, 1)), ("x", "style")),
        ("gen", "gen_blocks.1.conv_1", dict(x=a(3, 4, 4, 64), style=a(3, 32), noise=a(3, 8, 8, 1)), ("x", "style")),
        # a sharded style feeding a full-width conv (64 px at full width)
        ("gen", "gen_blocks.2.conv_1", dict(x=a(3, 8, 8, 32), style=a(3, 32), noise=a(3, 16, 16, 1)), ("x", "style")),
        ("critic", "from_rgbs.1.0", dict(x=a(3, 3, 8, 8)), ("x",)),  # 1x1
        ("critic", "conv_blocks.1.conv_1.0", dict(x=a(3, 32, 8, 8)), ("x",)),  # 3x3
        ("critic", "conv_blocks.2.conv_2", dict(x=a(3, 64, 4, 4)), ("x",)),  # 4x4, dense with a replicated bias
    ]
    cases, want = [], []
    for net, layer, inputs, wrt in kinds:
        model, tables = (gen, GEN_TABLES) if net == "gen" else (critic, CRITIC_TABLES)
        cases.append(dict(net=net, tables=tables, state=model.state_dict(), layer=layer, inputs=inputs, wrt=wrt))
        args = {k: (v.clone().requires_grad_(k in wrt) if v is not None else v) for k, v in inputs.items()}
        y = model.get_submodule(layer)(*args.values())
        y = torch.cat(y, dim=1) if isinstance(y, tuple) else y
        loss = (y * torch.cos(y)).sum()
        gx = torch.autograd.grad(loss, [args[k] for k in wrt], create_graph=True)
        params = list(model.parameters())
        grads = torch.autograd.grad(loss + sum(g.square().sum() for g in gx), params, allow_unused=True)
        want.append(dict(y=y.detach(), gx=[g.detach() for g in gx], grads={
            n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(model.named_parameters(), grads)}))
    return cases, want


def _step_cases(small):
    """Per case: the worker's payload, JAX's (2, 2)-mesh metrics and state
    after each iteration, and the port's one-process metrics and state."""
    from byogan_tpu.parallel.mesh import make_mesh, shard_batch, shard_train_state, tree_shardings
    from byogan_tpu.train.steps import make_train_step

    jgen, jcritic, jstate0 = small
    mesh = make_mesh(data=2, model=MODEL)
    shardings = tree_shardings(jstate0.gen_params, mesh, tp_min_features=TP_MIN)
    assert any("model" in str(s.spec) for s in jax.tree.leaves(shardings)), "precondition: no TP-sharded leaves"
    cases, want = [], []
    for knobs, fade, n in STEP_CASES.values():
        jcfg = small_config(ema_beta=0.5, **knobs)
        jstate = jstate0.replace(
            aug_p=jnp.float32(jcfg.aug_p) if jcfg.use_aug else None,
            rt_ema=jnp.float32(0.0) if jcfg.ada_target > 0 else None,
            pl_ema=jnp.float32(0.0) if jcfg.plr_weight > 0 else None,
        )
        pcfg = PortConfig(**dataclasses.asdict(jcfg))
        pstate = create_train_state(pcfg, *_port_nets(jstate), torch.device("cpu"))
        pstep = port_steps.make_train_step(pcfg, STEPS, BATCH, 10.0, (fade,), fade)
        jstep = make_train_step(jgen, jcritic, jcfg, steps=STEPS, batch=BATCH, fade_in=10.0,
                                critic_fade=(fade,), gen_fade=fade, donate=False)
        case = dict(
            config=dict(dataclasses.asdict(jcfg), data_axis=2, model_axis=MODEL),
            gen_tables=GEN_TABLES, critic_tables=CRITIC_TABLES[0],
            gen_state=generator_state_from_jax(jstate.gen_params),
            critic_state=critic_state_from_jax(jstate.critic_params),
            stage=STEPS, batch=BATCH, fade_in=10.0, fade=fade, iterations=[],
        )
        jm, pm = [], []
        for i in range(n):
            # placed as the first call's inputs, so a later call reuses its compile
            jstate = shard_train_state(jstate, mesh, tp_min_features=TP_MIN)
            real = np.random.default_rng(9 + i).integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
            if knobs:
                draws = _regularizer_draws(jstate.rng, jcfg, i, 8)
            else:
                draws = _jax_draws(jstate.rng, jcfg, STEPS)[0]
            case["iterations"].append((torch.from_numpy(real), draws))
            jstate, m = jstep(jstate, shard_batch(jnp.asarray(real), mesh))
            jm.append({k: float(v) for k, v in m.items()})
            pm.append({k: float(v) for k, v in pstep(pstate, torch.from_numpy(real), draws).items()})
        cases.append(case)
        want.append(dict(jax=(jm, jstate), one=(pm, pstate)))
    return cases, want


def _port_nets(jstate):
    gen = PortGenerator(*GEN_TABLES[0], **GEN_TABLES[1])
    gen.load_state_dict(generator_state_from_jax(jstate.gen_params))
    critic = PortCritic(*CRITIC_TABLES[0])
    critic.load_state_dict(critic_state_from_jax(jstate.critic_params))
    return gen, critic


@pytest.fixture(scope="module")
def small_jax():
    """(gen, critic, state) of the small JAX models with EMA, built once."""
    return build(small_config(ema_beta=0.5))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, small_jax):
    """One spawn of the four ranks for the module's cases: the shard and
    gather round trip, each layer kind, whole steps and ``train``."""
    tmp = tmp_path_factory.mktemp("tp")
    jstate = small_jax[2]
    full = dict(gen_state=generator_state_from_jax(jstate.gen_params),
                critic_state=critic_state_from_jax(jstate.critic_params))
    layers, layers_want = _layer_cases()
    steps, steps_want = _step_cases(small_jax)
    root = write_prepared_dataset(str(tmp / "data"), 8, 2, seed=2)
    train_cfg = dataclasses.asdict(_loop_config(tmp / "tp", root, data_axis=2, model_axis=MODEL))
    out = tp_dist.run(str(tmp), dict(
        roundtrip=dict(gen_tables=GEN_TABLES, critic_tables=CRITIC_TABLES[0], **full),
        layers=layers, steps=steps, train=dict(config=train_cfg, max_iters=TRAIN_ITERS),
    ))
    return dict(out=out, full=full, layers=layers_want, steps=steps_want, tmp=tmp, root=root)


# -- (a) the rule -------------------------------------------------------------


def _jax_full_width_params():
    """The full-width JAX generator's and critic's parameter shapes
    (``jax.eval_shape``, no compute)."""
    from byogan_tpu.core.random import synthesis_noise
    from byogan_tpu.models.factory import ModelSpec as JaxSpec
    from byogan_tpu.models.factory import build_critic as jax_critic
    from byogan_tpu.models.factory import build_generator as jax_gen

    def gen_init(k):
        return jax_gen(JaxSpec()).init(k, jnp.zeros((1, 512)), synthesis_noise(k, 1, 1), steps=1)["params"]

    def critic_init(k):
        return jax_critic(JaxSpec()).init(k, jnp.zeros((4, 4, 4, 3)), steps=1)["params"]

    key = jax.random.PRNGKey(0)
    return jax.eval_shape(gen_init, key), jax.eval_shape(critic_init, key)


# torch dim 0 under each layout change of compat/torch_ckpt.py: JAX's out dim
_OUT_DIM = {"linear": 1, "conv": 3, "bias": 0}


def _rule_table(jax_params, key_map, torch_shapes, model, tp_min):
    """Per leaf: (JAX's sharded dim or None, the port's sharded dim mapped
    to JAX's layout or None, elements)."""
    from byogan_tpu.parallel.mesh import make_mesh, sharding_for_leaf

    mesh = make_mesh(data=8 // model, model=model)
    rows = []
    for torch_key, path, kind in key_map:
        leaf = jax_params
        for p in path:
            leaf = leaf[p]
        spec = tuple(sharding_for_leaf("/".join(path), leaf.shape, mesh, tp_min).spec)
        jax_dim = spec.index("model") if "model" in spec else None
        port = sharding_for_param(torch_key, torch_shapes[torch_key], model, tp_min)
        rows.append((torch_key, jax_dim, None if port is None else _OUT_DIM[kind], int(np.prod(leaf.shape))))
    return rows


def _per_rank(rows, model):
    return sum(n // model if dim is not None else n for _, dim, _, n in rows)


@pytest.mark.parametrize("model", [2, 4])
def test_rule_picks_jax_s_leaves_and_dims_at_full_width(model):
    jgen, jcritic = _jax_full_width_params()
    gen, critic = build_generator(), build_critic()
    gen_rows = _rule_table(jgen, generator_key_map(), {k: v.shape for k, v in gen.state_dict().items()}, model, 256)
    critic_rows = _rule_table(jcritic, critic_key_map(), {k: v.shape for k, v in critic.state_dict().items()}, model, 256)
    for key, jax_dim, port_dim, _ in gen_rows + critic_rows:
        assert port_dim == jax_dim, (key, jax_dim, port_dim)
    sharded = {net: [k for k, d, _, _ in rows if d is not None] for net, rows in (("gen", gen_rows), ("critic", critic_rows))}
    assert len(sharded["gen"]) == 8 + 8 + 10 + 7 and len(sharded["critic"]) == 14 + 1
    assert sum(n for *_, n in gen_rows) == 20_446_312 and sum(n for *_, n in critic_rows) == 20_985_729
    assert sum(n for _, d, _, n in gen_rows if d is not None) == 19_599_360
    assert sum(n for _, d, _, n in critic_rows if d is not None) == 20_686_592
    per_rank = {2: (10_646_632, 10_642_433), 4: (5_746_792, 5_470_785)}[model]
    assert (_per_rank(gen_rows, model), _per_rank(critic_rows, model)) == per_rank
    # conv biases, noise weights, the const, to_rgb and adain's bias stay replicated
    assert not [k for k in sharded["gen"] + sharded["critic"] if k.endswith("bias") and "to_w_noise" not in k]
    # the replicated leaves each layer uses on its block only (summed over the
    # model group): a sharded layer's own bias, and a sharded synthesis conv's
    # noise weights
    for net, keys in ((gen, sharded["gen"]), (critic, sharded["critic"])):
        shard_module_(net, SimpleNamespace(model_size=model, model_rank=model - 1))
        assert sorted(net.tp_shards) == sorted(keys)
        want = {k[: -len("weight")] + "bias" for k in keys if k.endswith("weight")} - set(keys)
        want |= {k.replace(".conv.weight", ".inject_noise.weights") for k in keys if k.endswith(".conv.weight")}
        assert net.tp_partial == want


def test_rule_matches_jax_on_the_small_models(small_jax):
    jstate = small_jax[2]
    for net, params, key_map in (
        (PortGenerator(*GEN_TABLES[0], **GEN_TABLES[1]), jstate.gen_params, generator_key_map(3, 2)),
        (PortCritic(*CRITIC_TABLES[0]), jstate.critic_params, critic_key_map(3)),
    ):
        shapes = {k: v.shape for k, v in net.state_dict().items()}
        for model in (2, 4):
            rows = _rule_table(params, key_map, shapes, model, TP_MIN)
            for key, jax_dim, port_dim, _ in rows:
                assert port_dim == jax_dim, (key, model, jax_dim, port_dim)
            assert any(d is not None for _, d, _, _ in rows), "precondition: nothing sharded"
    # JAX's cases (tests/test_parallel.py:29-42), and a width the axis does not divide
    assert sharding_for_param("to_w_noise.0.layers.0.0.weight", (512, 512), 2) == 0
    assert sharding_for_param("gen_blocks.1.conv_1.conv.weight", (512, 512, 3, 3), 2) == 0
    assert sharding_for_param("to_rgbs.0.weight", (3, 512, 1, 1), 2) is None
    assert sharding_for_param("to_w_noise.0.layers.0.0.weight", (512, 512), 1) is None
    assert sharding_for_param("to_w_noise.0.layers.0.0.weight", (260, 16), 8) is None


# -- (b) shard and gather -------------------------------------------------------


def test_gather_of_shards_is_the_jax_state_bit_for_bit(ranks):
    full = ranks["full"]
    for r, o in enumerate(ranks["out"]):
        got = o["roundtrip"]
        for net in ("gen", "critic"):
            want = full[f"{net}_state"]
            assert set(got[net]) == set(want)
            for k in want:
                assert torch.equal(got[net][k], want[k]), (r, net, k)
            model_rank = o["mesh"][2]
            shapes = {k: tuple(v.shape) for k, v in shard_state_dict(want, model_rank, MODEL, TP_MIN).items()}
            assert got[f"{net}_shapes"] == shapes
            assert any(shapes[k] != tuple(want[k].shape) for k in want), "nothing sharded"


# -- (c) the layers -------------------------------------------------------------


def test_tp_layers_match_the_full_layer(ranks):
    for i, want in enumerate(ranks["layers"]):
        for o in ranks["out"]:
            got = o["layers"][i]
            what = f"rank {o['mesh'][0]} layer {i}"
            assert_rel(got["y"].numpy(), want["y"].numpy(), what=f"{what} forward")
            for g, w in zip(got["gx"], want["gx"]):
                assert_rel(g.numpy(), w.numpy(), what=f"{what} input gradient")
            for n, w in want["grads"].items():
                if w.abs().max() > 0:
                    assert_rel(got["grads"][n].numpy(), w.numpy(), what=f"{what} R1 parameter gradient {n}")
                else:
                    assert torch.equal(got["grads"][n], w), f"{what} {n}"


# -- (d), (e) whole steps -------------------------------------------------------


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_steps_match_jax_mesh_and_one_process(ranks, case):
    """Two steps in each fade bucket with EMA, and one penalized ADA + PLR
    step (the second derivative through the gathers), over data 2 x model 2
    from one full state on JAX's draws: every metric and the gathered nets
    and EMA as JAX's (2, 2)-mesh step at the port's bars and as the port's
    one process at JAX's; every rank the same gathered state; each rank's
    shards of the shapes the rule gives."""
    i = list(STEP_CASES).index(case)
    jm, jstate = ranks["steps"][i]["jax"]
    pm, pstate = ranks["steps"][i]["one"]
    out = [o["steps"][i] for o in ranks["out"]]
    for r, got in enumerate(out):
        assert got["counters"] == (len(jm), len(jm) * BATCH)
        for it, (g, j, p) in enumerate(zip(got["metrics"], jm, pm)):
            assert set(g) == set(j) == set(p), (sorted(g), sorted(j))
            for k in j:
                assert_rel(g[k], j[k], what=f"rank {r} iteration {it} {k}")
            for k in ("c_loss", "g_loss"):
                np.testing.assert_allclose(g[k], p[k], rtol=2e-5, err_msg=f"rank {r} iteration {it} {k}")
        for k in ("aug_p", "rt_ema", "pl_ema"):
            assert (k in got) == (getattr(jstate, k) is not None), k
            if k in got:
                assert_rel(got[k], float(getattr(jstate, k)), what=k)
        model_rank = ranks["out"][r]["mesh"][2]
        for net in ("gen", "critic", "gen_ema"):
            want = shard_state_dict(getattr(pstate, net).state_dict(), model_rank, MODEL, TP_MIN)
            assert got["shapes"][net] == {k: tuple(v.shape) for k, v in want.items()}, net
            for k, v in got[net].items():
                assert torch.equal(v, out[0][net][k]), f"rank {r} {net} {k}: the ranks differ"
    if case == "ada_plr":
        assert out[0]["metrics"][0]["pl_penalty"] > 0
    for net, jnet in (("gen", generator_state_from_jax(jstate.gen_params)),
                      ("critic", critic_state_from_jax(jstate.critic_params)),
                      ("gen_ema", generator_state_from_jax(jstate.gen_ema))):
        _assert_params(out[0][net], jnet)
        for k, v in getattr(pstate, net).state_dict().items():
            np.testing.assert_allclose(out[0][net][k].numpy(), v.numpy(), rtol=2e-3, atol=1e-5, err_msg=f"{net} {k}")


# -- (f) train ------------------------------------------------------------------


def _listing(d):
    return sorted(os.listdir(d))


def test_mesh_train_writes_one_gathered_checkpoint_that_resumes_in_one_process(ranks, tmp_path):
    """``train`` over data 2 x model 2 stopped after iteration 5: one
    checkpoint in the full layout of one process's, one metrics
    file whose losses are one process's, a sample grid; the checkpoint
    resumes in one process to the end of the one-process run."""
    root, tp = ranks["root"], ranks["tmp"] / "tp"
    got = [o["train"] for o in ranks["out"]]
    assert [(g["iters"], g["stage"]) for g in got] == [(TRAIN_ITERS, 2)] * 4
    one = _loop_config(tmp_path / "one", root)
    part = train(one, max_iters=TRAIN_ITERS, device="cpu")
    shards = shard_state_dict(part.gen.state_dict(), 0, MODEL, TP_MIN)
    assert all(g["shapes"] == {k: tuple(v.shape) for k, v in shards.items()} for g in got)
    assert got[0]["shapes"] != {k: tuple(v.shape) for k, v in part.gen.state_dict().items()}
    assert _listing(tp / "ck") == _listing(tmp_path / "one" / "ck") == [f"chk-{TRAIN_ITERS}.pth"]
    assert _listing(tp / "out") == _listing(tmp_path / "one" / "out") == ["metrics.jsonl", "s-3.png"]
    read = lambda d: [json.loads(line) for line in open(d / "metrics.jsonl")]  # noqa: E731
    tp_log, one_log = read(tp / "out"), read(tmp_path / "one" / "out")
    assert [r["iter"] for r in tp_log] == [r["iter"] for r in one_log] == [2, 4]
    for a, b in zip(tp_log, one_log):
        for k in ("c_loss", "g_loss", "rt"):
            assert_rel(a[k], b[k], what=f"iter {a['iter']} {k}")
    ckpt = str(tp / "ck" / f"chk-{TRAIN_ITERS}.pth")
    saved = torch.load(ckpt, weights_only=False)
    _assert_params(saved["gen"], part.gen.state_dict())
    _assert_params(saved["critic"], part.critic.state_dict())
    for net, opt in (("gen", "gen_opt"), ("critic", "critic_opt")):
        want = getattr(part, opt).state_dict()["state"]
        assert {i: {k: tuple(v.shape) for k, v in s.items()} for i, s in saved[opt]["state"].items()} == \
            {i: {k: tuple(v.shape) for k, v in s.items()} for i, s in want.items()}, opt
    full = train(_loop_config(tmp_path / "full", root), device="cpu")
    resumed = train(_loop_config(tp, root), checkpoint=ckpt, device="cpu")
    assert (resumed.iters, resumed.stage, resumed.im_count) == (full.iters, full.stage, full.im_count) == (8, 2, 16)
    _assert_params(resumed.gen.state_dict(), full.gen.state_dict())
    _assert_params(resumed.critic.state_dict(), full.critic.state_dict())


# -- (g) config and mesh errors -------------------------------------------------


def test_config_and_mesh_checks(ranks, tmp_path):
    assert PortConfig(model_axis=2).model_axis == 2
    assert (PortConfig(data_axis=2, model_axis=2).data_axis, PortConfig(data_axis=2, model_axis=2).model_axis) == (2, 2)
    with pytest.raises(ValueError, match="data_axis and model_axis must be >= 1"):
        PortConfig(model_axis=0)
    with pytest.raises(ValueError, match=r"mesh 1x2 \(data_axis x model_axis\) needs 2 processes"):
        port_mesh.make_mesh(1, 2, device="cpu")
    assert not torch.distributed.is_initialized()
    errors = ranks["out"][0]["errors"]
    assert errors[0].startswith("mesh 3x2 needs 6 processes, one per card, and the process group has 4"), errors
    assert errors[1].startswith("mesh 1x3 needs 3 processes"), errors
    # (global, data, model rank, data size, model size): np.reshape(data, model)'s layout
    assert [o["mesh"] for o in ranks["out"]] == [(0, 0, 0, 2, 2), (1, 0, 1, 2, 2), (2, 1, 0, 2, 2), (3, 1, 1, 2, 2)]
    check_data_axis(PortConfig(batch_progression=(2, 2), epoch_progression=(1, 1), data_axis=2, model_axis=2), 2)
    with pytest.raises(ValueError, match=r"batch_progression entries \[\(1, 3\)\] .* data-parallel axis \(2\)"):
        check_data_axis(PortConfig(batch_progression=(3, 4), epoch_progression=(1, 1), model_axis=2), 2)


# -- (h) the CLI ----------------------------------------------------------------


def test_cli_trains_over_the_model_axis_under_torchrun(tmp_path):
    """Two gloo ranks, data 1 x model 2, at widths of 256 so that the
    default threshold shards (the reference's 8 stages and mapping depth,
    which the JAX package's .pth reader takes; two iterations at 4 px): one
    checkpoint in the full layout, which the JAX package reads."""
    from byogan_tpu.train.checkpoint import load_checkpoint

    root = write_prepared_dataset(str(tmp_path / "data"), 4, 1, seed=3)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        "[tiny]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 2\n"
        "batch_progression = 4,4,4,4,4,4,4,4\nepoch_progression = 3,1,1,1,1,1,1,1\nmodel_axis = 2\nrefresh_stat_step = 1\n"
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
    assert proc.stdout.count("mesh: data 1 x model 2 (gloo)") == 1
    assert _listing(tmp_path / "ck") == ["chk-2.pth"]
    assert [json.loads(line)["iter"] for line in open(tmp_path / "out" / "metrics.jsonl")] == [1, 2]
    saved = torch.load(tmp_path / "ck" / "chk-2.pth", weights_only=False)
    full = build_generator(ModelSpec(channel_divisor=2), z_dim=16).state_dict()
    assert {k: v.shape for k, v in saved["gen"].items()} == {k: v.shape for k, v in full.items()}
    assert sharding_for_param("to_w_noise.0.layers.1.0.weight", full["to_w_noise.0.layers.1.0.weight"].shape, 2) == 0
    for k, v in generator_state_from_jax(load_checkpoint(str(tmp_path / "ck" / "chk-2.pth"))["gen_params"]).items():
        assert torch.equal(v, saved["gen"][k]), k
