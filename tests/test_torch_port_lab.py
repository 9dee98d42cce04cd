"""The port's CIE Lab -> sRGB conversion and its Lab TIFF and PSD readers
against Pillow and the JAX package, on the CPU.

Pillow 12.1.0 converts a LAB image to RGB through LittleCMS 2.17
(``ImageCms.buildTransform`` of its Lab and sRGB profiles, perceptual
intent: a 33-point 16-bit CLUT sampled from the float pipeline,
tetrahedral interpolation in lcms2's fixed point).  The port's
``native/lab.cpp`` rebuilds that transform from its parts; it is held to
Pillow on all 2^24 Lab triples with 0 differences, and the manifest
records the SHA-256 of that table, which ``chip_smoke.py`` matches on the
card's machine (no LittleCMS there).  Then Lab TIFFs
(``fx.lab_tiff_layouts``: a* and b* stored signed, XOR 0x80 into Pillow's
bands in one plane, as they are in separate planes) and Lab PSDs
(``fx.lab_psd_layouts``: a* and b* stored with 128 as zero), Pillow's own
LAB TIFF writer, the layouts Pillow does not identify refused by name, and
the JAX package's prep, loader fallback and ``cli.project`` on Lab
originals.  Tolerance 0.
"""

import hashlib
import os
import re
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _same_as_pillow, _write  # noqa: E402

TIFF_LAYOUTS = fx.lab_tiff_layouts()
PSD_LAYOUTS = fx.lab_psd_layouts()
REFUSALS = {k: v for k, v in fx.tiff_refusals().items() if "lab" in k}


def test_lab_to_rgb_is_pillows_on_every_triple():
    """All 2^24 triples, in index order, equal to Pillow's convert("RGB"),
    and to the manifest's hash of Pillow's table."""
    want = fx.lab_table_pillow()
    got = native.lab_to_rgb(fx.lab_table_triples())
    bad = np.flatnonzero(np.any(got != want, axis=1))
    assert len(bad) == 0, f"{len(bad)} triples differ, the first {fx.lab_table_triples()[bad[:5]].tolist()}"
    assert hashlib.sha256(got.tobytes()).hexdigest() == fx.load_manifest()["lab_table"]["sha256_rgb"]


def test_lab_to_rgb_keeps_the_shape_and_refuses_other_shapes():
    lab = np.random.default_rng(2190).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    got = native.lab_to_rgb(lab)
    assert got.shape == lab.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got.reshape(-1, 3), native.lab_to_rgb(lab.reshape(-1, 3)))
    with pytest.raises(ValueError, match="Lab triples"):
        native.lab_to_rgb(lab[..., :2])


@pytest.mark.parametrize("name", sorted(TIFF_LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_lab_tiff_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".jpg", TIFF_LAYOUTS[name])  # under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(PSD_LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_lab_psd_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".png", PSD_LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_lab_tiff_pillow_does_not_identify_is_refused_by_name(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name, data)
    with pytest.raises(Exception, match="cannot identify"):
        Image.open(path)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"])
def test_pillow_written_lab_tiff_matches_pillow(tmp_path, compression):
    """Pillow's own LAB writer (libtiff for the compressed ones)."""
    bands = fx.smooth_scene(2191, 21, 33, cell=8, step=8).transpose(2, 0, 1)
    im = Image.merge("LAB", [Image.fromarray(b.astype(np.uint8)) for b in bands])
    path = str(tmp_path / "lab.bmp")
    im.save(path, format="TIFF", compression=compression)
    assert _same_as_pillow(path, compression)


def _seeded_lab(r) -> bytes:
    """A Lab TIFF or PSD over the layouts' parameters together."""
    h, w = int(r.integers(1, 30)), int(r.integers(1, 30))
    lab = r.integers(0, 256, (h, w, 3))
    if r.random() < 0.2:
        planes = r.integers(0, 256, (3 + int(r.integers(0, 2)), h, w)).astype(np.uint8)
        return fx.psd_file(planes, 9, w, compression=int(r.integers(0, 2)))
    kw = {"order": "<" if r.random() < 0.6 else ">", "compression": int(r.choice([1, 5, 8, 32946, 32773])),
          "big": bool(r.random() < 0.2)}
    if kw["big"]:
        kw["order"] = "<"
    if r.random() < 0.4:
        kw["predictor"] = 2
    if r.random() < 0.3:
        kw["planar"] = 2
    if r.random() < 0.3:
        kw["tile"] = (16, int(r.choice([16, 32])))
    elif r.random() < 0.5:
        kw["rows_per_strip"] = int(r.integers(1, h + 2))
    if r.random() < 0.2:
        kw["orientation"] = int(r.integers(1, 9))
    return fx.tiff_bytes(lab, photometric=8, **kw)


@pytest.mark.parametrize("seed", range(2))
def test_seeded_lab_files_match_pillow(tmp_path, seed):
    """80 seeded files a seed: each Pillow reads decodes to its pixels, each
    it refuses (a PSD with a fourth channel under PackBits) raises naming
    the file."""
    r = np.random.default_rng(2192 + seed)
    assert sum(_same_as_pillow(_write(tmp_path, f"l{t}.png", _seeded_lab(r)), f"file {t}") for t in range(80)) > 72


def _originals(root: str) -> str:
    """Lab originals under listed names: an LZW TIFF with Predictor 2
    (.jpg), a PackBits PSD (.png), a tiled TIFF in separate planes (.bmp),
    a raw PSD with alpha (.webp)."""
    os.makedirs(root)
    r = np.random.default_rng(2193)
    img = fx.smooth_scene(2194, 37, 45, cell=8, step=8)
    planes = np.concatenate([img, img[..., :1]], 2).transpose(2, 0, 1)
    data = {
        "a.jpg": fx.tiff_bytes(img, photometric=8, compression=5, predictor=2, rows_per_strip=9),
        "b.png": fx.psd_file(planes[:3], 9, 45, compression=1),
        "c.bmp": fx.tiff_bytes(r.integers(0, 256, (37, 45, 3)), photometric=8, planar=2, tile=(16, 32)),
        "d.webp": fx.psd_file(planes, 9, 45),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_lab_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of Lab originals under listed names."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    from byogan_tpu_torch.cli import prep as port_prep_cli
    from byogan_tpu_torch.data.png import read_png

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 32, workers=2)
    port_prep_cli.main([port_root, "4", "32", "-y", "-w", "2", "-d", "cpu"])
    n = 0
    for k in range(1, 5):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 4
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 16


def test_loader_reads_lab_as_jax_pillow_fallback(tmp_path):
    """A prepared set of Lab TIFFs and PSDs under listed names: the port's
    loader reads each as the JAX package's ``StageDataset`` does through its
    Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2195)
    for i in range(6):
        lab = r.integers(0, 256, (16, 16, 3))
        data = (fx.psd_file(lab.transpose(2, 0, 1), 9, 16, compression=i % 2) if i % 3 == 2
                else fx.tiff_bytes(lab, photometric=8, compression=(1, 5)[i % 2], big=i == 4))
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)
