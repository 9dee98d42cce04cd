"""The port's CLI surface against the JAX package's, on the CPU.

``latest_checkpoint`` and ``cli.main --auto-resume`` (byogan_tpu/train/
checkpoint.py:196-229, cli/main.py:37-68; the cases of tests/
test_checkpoint.py:47-66 and tests/test_train_loop.py:210), ``--pallas``
on the sampling CLIs (accepted, no effect), ``generate_samples --format
jpeg``, and ``cli.plot`` beside JAX's on one metrics file.
"""

import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from byogan_tpu_torch.data.images import read_image
from byogan_tpu_torch.data.synthetic import write_prepared_dataset
from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
from byogan_tpu_torch.train import checkpoint as port_ckpt
from byogan_tpu_torch.train.config import TrainConfig
from byogan_tpu_torch.train.state import create_train_state

SPEC = ModelSpec(channel_divisor=32, num_stages=2, mapping_depth=2)


@pytest.fixture(scope="module")
def tiny_state():
    return create_train_state(
        TrainConfig(noise_size=16), build_generator(SPEC, z_dim=16, generator=torch.Generator().manual_seed(1)),
        build_critic(SPEC), torch.device("cpu"),
    )


def _save(directory, state, iters, name=None):
    state.iters = iters
    return port_ckpt.save_checkpoint(str(directory), state, None, name=name, model_spec=SPEC)


def test_latest_checkpoint_picks_the_newest(tmp_path, tiny_state):
    for it in (10, 200, 30):
        _save(tmp_path, tiny_state, it)
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "chk-200.pth")
    assert port_ckpt.latest_checkpoint(str(tmp_path / "nope")) is None
    assert port_ckpt.latest_checkpoint(str(tmp_path / "chk-10.pth")) is None  # a file, not a directory


def test_latest_checkpoint_prefers_final(tmp_path, tiny_state):
    """FINAL on a tie (written after the periodic save at its iteration);
    a periodic checkpoint newer than FINAL (a fresh run in an old
    directory) wins."""
    _save(tmp_path, tiny_state, 100)
    _save(tmp_path, tiny_state, 100, name="FINAL")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "FINAL.pth")
    _save(tmp_path, tiny_state, 150)
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "chk-150.pth")
    _save(tmp_path, tiny_state, 150, name="FINAL")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "FINAL.pth")


def test_latest_checkpoint_skips_partial_saves_and_a_corrupt_final(tmp_path, tiny_state):
    """A save cut short leaves ``*.pth.tmp`` (the port's saves are atomic):
    never picked.  A FINAL that cannot be read falls back to the periodic
    checkpoint; with no periodic one, to nothing."""
    good = _save(tmp_path, tiny_state, 5)
    shutil.copy(good, tmp_path / "chk-9.pth.tmp")
    shutil.copy(good, tmp_path / "FINAL.pth.tmp")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == good
    (tmp_path / "FINAL.pth").write_bytes(b"PK\x03\x04 not a whole checkpoint")
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == good
    torch.save({"step": 2}, tmp_path / "FINAL.pth")  # readable, no iter
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == good
    os.remove(good)
    assert port_ckpt.latest_checkpoint(str(tmp_path)) is None


def _cli_config(tmp_path, root, name):
    cfg = tmp_path / f"{name}.txt"
    cfg.write_text(
        f"[{name}]\n"
        f"data = {root}\nnoise_length = 16\ncompute_dtype = float32\nchannel_divisor = 32\n"
        "mapping_depth = 2\nbatch_progression = 4,4\nepoch_progression = 2,2\nrefresh_stat_step = 1\n"
        f"checkpoint_dir = {tmp_path / name / 'ck'}\noutput_dir = {tmp_path / name / 'out'}\n"
    )
    return str(cfg)


def _losses(tmp_path, name):
    with open(tmp_path / name / "out" / "metrics.jsonl") as f:
        return [(r["iter"], r["c_loss"], r["g_loss"]) for r in map(json.loads, f)]


def test_auto_resume_matches_an_explicit_resume(tmp_path, capsys):
    """The CLI stopped at iteration 3, then resumed with ``--auto-resume``
    and no ``-c``: the same losses and weights as a resume with ``-c``; a
    finished run resumes from FINAL and trains nothing; ``-c`` wins."""
    from byogan_tpu_torch.cli.main import main

    root = write_prepared_dataset(str(tmp_path / "data"), 8, 2, seed=4)
    auto, explicit = _cli_config(tmp_path, root, "auto"), _cli_config(tmp_path, root, "explicit")
    fresh = main(["auto", "--config-file", auto, "-d", "cpu", "--auto-resume", "--max-iters", "3"])
    assert fresh.iters == 3 and "auto-resuming" not in capsys.readouterr().out
    shutil.copytree(tmp_path / "auto", tmp_path / "explicit")
    a = main(["auto", "--config-file", auto, "-d", "cpu", "--auto-resume"])
    assert f"auto-resuming from {tmp_path / 'auto' / 'ck' / 'chk-3.pth'}" in capsys.readouterr().out
    b = main(["explicit", "--config-file", explicit, "-d", "cpu", "-c", str(tmp_path / "explicit" / "ck" / "chk-3.pth")])
    assert a.iters == b.iters == 8
    assert _losses(tmp_path, "auto") == _losses(tmp_path, "explicit")
    for net in ("gen", "critic"):
        want = getattr(b, net).state_dict()
        for k, v in getattr(a, net).state_dict().items():
            torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=f"{net} {k}")

    again = main(["auto", "--config-file", auto, "-d", "cpu", "--auto-resume"])
    assert f"auto-resuming from {tmp_path / 'auto' / 'ck' / 'FINAL.pth'}" in capsys.readouterr().out
    assert again.iters == 8 and len(_losses(tmp_path, "auto")) == 8
    first = main(["auto", "--config-file", auto, "-d", "cpu", "--auto-resume", "--max-iters", "4",
                  "-c", str(tmp_path / "auto" / "ck" / "chk-3.pth")])
    assert first.iters == 4 and "auto-resuming" not in capsys.readouterr().out


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    g = build_generator(SPEC, z_dim=16, generator=torch.Generator().manual_seed(2))
    path = str(tmp_path_factory.mktemp("ckpt") / "gen.pth")
    torch.save({"gen": g.state_dict(), "step": 2, "alpha": None, "model": SPEC.to_dict()}, path)
    return path


def test_pallas_is_accepted_and_changes_nothing(tiny_ckpt, tmp_path):
    """JAX's ``--pallas`` flag on both sampling CLIs: the frames are the
    same bytes with and without it."""
    from byogan_tpu_torch.cli.generate_samples import main as generate
    from byogan_tpu_torch.cli.interpolate import main as interpolate

    outs = {}
    for flag in ([], ["--pallas"]):
        gen_dir, walk_dir = tmp_path / f"g{len(flag)}", tmp_path / f"w{len(flag)}"
        gen_dir.mkdir()
        generate([tiny_ckpt, "3", "-d", "cpu", "-o", str(gen_dir), "--seed", "5"] + flag)
        interpolate([tiny_ckpt, "-o", str(walk_dir), "-n", "2", "-p", "3", "-d", "cpu", "--seed", "1"] + flag)
        outs[len(flag)] = {d.name[0] + "/" + f: (d / f).read_bytes() for d in (gen_dir, walk_dir)
                           for f in sorted(os.listdir(d))}
    assert sorted(outs[0]) == ["g/image_1.png", "g/image_2.png", "g/image_3.png",
                               "w/image_1.png", "w/image_2.png", "w/image_3.png"]
    assert outs[0] == outs[1]


def test_generate_samples_writes_jpeg_frames(tiny_ckpt, tmp_path):
    """``--format jpeg`` writes ``image_{i}.jpg`` through the native lane's
    libjpeg at ``--jpeg-quality``; each decodes (the port and Pillow agree)
    to the PNG frame of the same seed put through the same encoder."""
    from byogan_tpu_torch.data import native
    from byogan_tpu_torch.cli.generate_samples import main as generate

    for fmt in ("png", "jpeg"):
        (tmp_path / fmt).mkdir()
        generate([tiny_ckpt, "3", "-d", "cpu", "-o", str(tmp_path / fmt), "--seed", "3", "--format", fmt,
                  "--jpeg-quality", "100"])
    assert sorted(os.listdir(tmp_path / "jpeg")) == [f"image_{i}.jpg" for i in (1, 2, 3)]
    for i in (1, 2, 3):
        got = read_image(str(tmp_path / "jpeg" / f"image_{i}.jpg"))
        with Image.open(tmp_path / "jpeg" / f"image_{i}.jpg") as im:
            np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
        native.encode_jpeg(str(tmp_path / "again.jpg"), read_image(str(tmp_path / "png" / f"image_{i}.png")), 100)
        assert got.shape == (8, 8, 3)
        np.testing.assert_array_equal(got, read_image(str(tmp_path / "again.jpg")))
    with pytest.raises(SystemExit):
        generate([tiny_ckpt, "1", "-d", "cpu", "-o", str(tmp_path), "--format", "jpeg", "--jpeg-quality", "0"])


def test_save_stream_writes_jpeg_frames(tiny_ckpt, tmp_path):
    """``Sampler.save_stream(format="jpeg")``: the sampler's frames through
    libjpeg at ``jpeg_quality``, named ``image_{i}.jpg``."""
    from byogan_tpu_torch.data import native
    from byogan_tpu_torch.serve import Sampler

    frames = Sampler(tiny_ckpt, batch=2, seed=4, device="cpu").sample(3)
    assert Sampler(tiny_ckpt, batch=2, seed=4, device="cpu").save_stream(
        str(tmp_path / "s"), 3, format="jpeg", jpeg_quality=80) == 3
    assert sorted(os.listdir(tmp_path / "s")) == [f"image_{i}.jpg" for i in (1, 2, 3)]
    for i, frame in enumerate(frames, 1):
        native.encode_jpeg(str(tmp_path / "want.jpg"), frame, 80)
        np.testing.assert_array_equal(read_image(str(tmp_path / "s" / f"image_{i}.jpg")),
                                      read_image(str(tmp_path / "want.jpg")))


def _metrics_file(path, msssim):
    recs = [{"iter": i, "stage": 1 + (i > 4), "epoch": 0, "c_loss": 2.0 / i, "g_loss": 1.0 + 0.1 * i,
             "images_per_sec": 10.0 + i} for i in range(2, 10, 2)]
    recs.append({"iter": 4, "kind": "eval", "stage": 1, "swd": 320.0, "swd_ema": 300.0})
    recs.append({"kind": "eval", "iter": 8, "stage": 2, "swd": 300.0, "swd_ema": 280.0})
    if msssim:
        for r, v in zip(recs[-2:], (0.45, 0.4)):
            r.update({"msssim": v, "msssim_ema": v - 0.02, "msssim_real": 0.3})
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return str(path)


def _figure(plot_main, argv):
    """The figure ``plot_main`` builds: every axis's label and the data,
    label and style of each of its lines."""
    import matplotlib.pyplot as plt

    figs = []
    with mock.patch.object(plt, "close", side_effect=figs.append):
        plot_main(argv)
    (fig,) = figs
    out = [(ax.get_ylabel(), [(line.get_label(), line.get_xydata().tolist(), line.get_color(), line.get_linestyle(),
                               line.get_marker()) for line in ax.get_lines()]) for ax in fig.axes]
    plt.close(fig)
    return out


@pytest.mark.parametrize("msssim", [False, True])
def test_plot_matches_jax(tmp_path, msssim):
    """The same Line2D data on every axis as JAX's ``cli.plot`` (losses,
    stage boundaries, throughput, SWD, MS-SSIM's twin axis), for one run
    and two overlaid; both write a PNG; a run directory works too."""
    from byogan_tpu.cli.plot import main as jax_plot
    from byogan_tpu_torch.cli.plot import main as port_plot

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    one = _metrics_file(tmp_path / "a" / "metrics.jsonl", msssim)
    _metrics_file(tmp_path / "b" / "metrics.jsonl", not msssim)
    for args in ([one], [str(tmp_path / "a"), str(tmp_path / "b"), "--title", "two runs"]):
        want = _figure(jax_plot, args + ["-o", str(tmp_path / "jax.png")])
        got = _figure(port_plot, args + ["-o", str(tmp_path / "port.png")])
        assert got == want
        assert len(got) == (4 if msssim or len(args) > 1 else 3)
        assert os.path.getsize(tmp_path / "port.png") > 10_000 and os.path.getsize(tmp_path / "jax.png") > 10_000
    with pytest.raises(SystemExit, match="no metrics file"):
        port_plot([str(tmp_path / "missing.jsonl")])


def test_only_the_plot_cli_imports_matplotlib():
    code = ("import sys, pkgutil, importlib, byogan_tpu_torch\n"
            "for m in pkgutil.walk_packages(byogan_tpu_torch.__path__, 'byogan_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('matplotlib' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
