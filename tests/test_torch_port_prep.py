"""The port's dataset preparation against the JAX package's, on the CPU.

``core/resize.py`` reproduces Pillow's ``Image.BILINEAR`` resize of uint8
images, so the comparisons are exact: every level of the pyramid bit-equal
to Pillow's and to JAX's ``prepare_pyramid`` (which resizes with Pillow),
from originals under each of PNG's five row filters, non-square and
smaller than the target.  The card's route (int32 banded sums) runs here
on CPU tensors too.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from byogan_tpu_torch.cli import prep as port_prep_cli
from byogan_tpu_torch.core import resize
from byogan_tpu_torch.data.pipeline import StageDataset
from byogan_tpu_torch.data.png import read_png
from byogan_tpu_torch.data.prep import prepare_pyramid
from byogan_tpu_torch.data.synthetic import encode_png_filtered

SIZES = (512, 256, 128, 64, 32, 16, 8, 4)


@pytest.mark.parametrize("shape", [(700, 640), (513, 1024), (300, 200), (37, 5)])
def test_resize_matches_pil_at_every_level(shape):
    """The 4 -> 512 chain, each level from the previous, on a random image:
    the plain version and the card's route equal Pillow bit for bit."""
    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    pil, prev = Image.fromarray(img), img
    for size in SIZES:
        pil = pil.resize((size, size), Image.BILINEAR)
        plain = resize.resize_uint8_bilinear_pil_plain(prev, size)
        np.testing.assert_array_equal(plain, np.asarray(pil), err_msg=f"{shape} -> {size}")
        if max(prev.shape) <= 128:  # the card's int32 route, here on the CPU (slow at the large levels)
            card = resize._resize(torch.from_numpy(prev), size, resize._pil_pass)
            np.testing.assert_array_equal(card.numpy(), plain, err_msg=f"card route {shape} -> {size}")
        prev = plain
    torch.testing.assert_close(resize.resize_uint8_bilinear_pil(torch.from_numpy(img), 16),
                               torch.from_numpy(resize.resize_uint8_bilinear_pil_plain(img, 16)), rtol=0, atol=0)


def _originals(root):
    """Originals of every row filter, non-square, and some smaller than the
    largest target (32 px); one RGBA file written by PIL."""
    r = np.random.default_rng(5)
    shapes = [(40, 36), (24, 50), (20, 20), (64, 64), (33, 47)]
    os.makedirs(root)
    for k, shape in enumerate(shapes):
        img = r.integers(0, 256, shape + (3,), dtype=np.uint8)
        with open(os.path.join(root, f"pic-{k}.png"), "wb") as f:
            f.write(encode_png_filtered(img, k))
    Image.fromarray(r.integers(0, 256, (30, 41, 4), dtype=np.uint8)).save(os.path.join(root, "alpha.png"))
    return root


def test_prepare_pyramid_matches_jax(tmp_path):
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    progress = []
    want = jax_prepare(jax_root, 4, 32, workers=2)
    got = prepare_pyramid(port_root, 4, 32, workers=2, progress=lambda d, t: progress.append((d, t)), device="cpu")
    assert [os.path.relpath(p, port_root) for p in got] == [os.path.relpath(p, jax_root) for p in want]
    assert progress == [(i, 6) for i in range(1, 7)]
    assert sorted(os.listdir(os.path.join(port_root, "original", "images"))) == \
        sorted(os.listdir(os.path.join(jax_root, "original", "images")))
    for k in range(1, 5):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) == [f"image-{n}.png" for n in range(6)]
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                jax_px = np.asarray(im)
            port_px = read_png(os.path.join(port_root, sub, name))
            assert port_px.shape == (4 * 2 ** (k - 1),) * 2 + (3,)
            np.testing.assert_array_equal(port_px, jax_px, err_msg=f"set_{k} {name}")


def test_prep_cli_overwrite_and_pack(tmp_path, capsys, monkeypatch):
    """JAX's CLI surface (tests/test_cli.py:34): the sets, the prompt
    before a rebuild (kept on "n", rebuilt with ``-y`` or "y"), and
    ``--pack``: each set's packed.npy equals its PNGs in the loader's
    order, packed on the ``-w`` threads."""
    root = _originals(str(tmp_path / "ds"))
    packs = []
    real_pack = port_prep_cli.pack_stage
    monkeypatch.setattr(port_prep_cli, "pack_stage",
                        lambda root, k, workers: packs.append((k, workers)) or real_pack(root, k, workers))
    port_prep_cli.main([root, "4", "16", "-y", "-w", "2", "--pack", "-d", "cpu"])
    assert "dataset ready: 3 resolution sets" in capsys.readouterr().out
    assert packs == [(1, 2), (2, 2), (3, 2)]
    for k in (1, 2, 3):
        ds = StageDataset(root, k)
        packed = np.load(os.path.join(ds.set_dir, "packed.npy"))
        assert packed.shape == (6, 4 * 2 ** (k - 1), 4 * 2 ** (k - 1), 3)
        for i, path in enumerate(ds.files):
            np.testing.assert_array_equal(packed[i], read_png(path))
    marker = os.path.join(root, "prepared", "set_1", "images", "image-0.png")
    os.utime(marker, (0, 0))
    asked = []
    monkeypatch.setattr("builtins.input", lambda q: asked.append(q) or "n")
    port_prep_cli.main([root, "4", "16", "-d", "cpu"])
    assert asked == [f"set_{k} exists. Delete? (y/N)" for k in (1, 2, 3)] and os.path.getmtime(marker) == 0
    monkeypatch.setattr("builtins.input", lambda q: "y")
    port_prep_cli.main([root, "4", "16", "-d", "cpu"])
    assert os.path.getmtime(marker) > 0


def test_prep_refuses_a_webp_original(tmp_path):
    """A WebP original raises before any set is written, naming the file
    (JPEG and BMP originals are decoded: the test below)."""
    root = _originals(str(tmp_path / "ds"))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(root, "photo.webp"))
    with pytest.raises(OSError, match=r"photo\.webp: the original's format is WebP"):
        prepare_pyramid(root, 4, 8, device="cpu")
    assert not os.path.exists(os.path.join(root, "prepared"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prepare_pyramid(root, 4, 8)


def test_prepare_pyramid_matches_jax_on_a_jpeg_original(tmp_path):
    """JPEG (and BMP) originals beside PNG ones, written by Pillow: the
    port decodes them through the native lane (libjpeg) and numpy, and
    every level of the pyramid equals JAX's ``prepare_pyramid`` (PIL's
    decode and resize) bit for bit."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    def originals(root):
        r = np.random.default_rng(9)
        os.makedirs(root)
        smooth = np.linspace(0, 255, 48 * 40 * 3).reshape(48, 40, 3)
        Image.fromarray((smooth + r.normal(0, 6, smooth.shape)).clip(0, 255).astype(np.uint8)).save(
            os.path.join(root, "a.jpg"), quality=90)
        Image.fromarray(r.integers(0, 256, (36, 52, 3), dtype=np.uint8)).save(os.path.join(root, "b.jpeg"))
        Image.fromarray(r.integers(0, 256, (21, 34, 3), dtype=np.uint8)).save(os.path.join(root, "c.bmp"))
        with open(os.path.join(root, "d.png"), "wb") as f:
            f.write(encode_png_filtered(r.integers(0, 256, (40, 40, 3), dtype=np.uint8), 4))
        return root

    jax_root, port_root = originals(str(tmp_path / "jax")), originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 32, workers=2)
    prepare_pyramid(port_root, 4, 32, workers=2, device="cpu")
    for k in range(1, 5):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) == [f"image-{n}.png" for n in range(4)]
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
