"""The port's JPEG-compressed and YCbCr TIFFs against Pillow, on the CPU.

The JAX package reads a TIFF under a listed extension through Pillow alone
(its prep, ``cli.project`` and its loader's fallback): Pillow 12.1.0 with
libtiff 4.7.1.  Compression 7 goes through libtiff's JPEG codec, which
reads the JPEGTables stream before each strip's or tile's and decodes with
libjpeg-turbo (YCbCr converted to RGB by libjpeg, the other photometric
interpretations' components as they are); YCbCr under LZW, Deflate or
PackBits through libtiff's TIFFRGBAImage (its YCbCr tables and put
routines, with their quirks); uncompressed YCbCr through Pillow's raw
decoder as RGBX.  ``native/tiff.cpp`` is held bit for bit to Pillow's
``convert("RGB")`` on files Pillow's writer makes through libtiff, on the
libjpeg writer's other samplings, and on seeded files of every layout; the
JAX package's prep, loader fallback and ``cli.project`` on such originals
against the port's.  JPEG in separate planes (a one-component stream a
plane a strip or tile: gray, RGB and CMYK planes interleaved back, YCbCr 1
x 1 through TIFFRGBAImage) and YCbCr under Predictor 2 (libtiff's row unit,
and its checks that leave the predictor undone) are held here on their
layouts (``fx.jpeg_planes_predictor_layouts``), refusals
(``fx.jpeg_planes_refusals``) and seeded files.  The other fixed layouts
and refusals are in ``test_torch_port_tiff.py`` (``fx.ycbcr_jpeg_layouts``,
``fx.tiff_refusals``).  Tolerance 0.
"""

import os
import re
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

SAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
PLANES_LAYOUTS = fx.jpeg_planes_predictor_layouts()
PLANES_REFUSALS = fx.jpeg_planes_refusals()


@pytest.mark.parametrize("name", sorted(PLANES_LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_jpeg_planes_and_ycbcr_predictor_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).replace(".tif", ".jpg"), PLANES_LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(PLANES_REFUSALS), ids=lambda n: n[:-4])
def test_refused_jpeg_planes_raise_naming_the_file_and_the_kind(tmp_path, name):
    """Subsampled YCbCr planes and a plane's stream of other factors than
    1 x 1: libtiff refuses them, and so does Pillow."""
    data, reason = PLANES_REFUSALS[name]
    path = _write(tmp_path, name.replace(".tif", ".png"), data)
    assert isinstance(_pillow(path), Exception)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


def _seeded_planes_or_predictor(r) -> bytes:
    """A TIFF of JPEG streams in separate planes (gray, RGB, CMYK, YCbCr 1 x
    1 and now and then subsampled; strips or tiles; tables; a full last
    strip; byte order, orientation) or of YCbCr blocks under Predictor 2
    (every sampling, LZW, Deflate, PackBits; strips of rows that are or
    are not whole blocks, tiles; one plane or three)."""
    h, w = int(r.integers(1, 40)), int(r.integers(1, 40))
    kw = {"order": "<" if r.random() < 0.6 else ">"}
    if r.random() < 0.2:
        kw["orientation"] = int(r.integers(1, 9))
    tiled = r.random() < 0.4
    if r.random() < 0.5:
        photometric = int(r.choice([1, 2, 2, 5, 6, 6]))
        img = fx.smooth_scene(int(r.integers(1 << 30)), h, w, cell=8, step=int(r.integers(1, 8)))
        samples = {1: img[..., 1], 2: img, 6: img}.get(photometric)
        if photometric == 5:
            samples = np.concatenate([img, img.min(axis=2, keepdims=True) // 2], 2)
        if tiled:
            kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))
        else:
            kw["rows_per_strip"] = int(r.integers(1, h + 1))
            kw["full_last"] = r.random() < 0.3
        sampling = (1, 1) if r.random() < 0.85 else (2, 2)
        return fx.jpeg_tiff(samples, photometric, int(r.integers(5, 101)), sampling, tables=r.random() < 0.7,
                            planar=2, **kw)
    if r.random() < 0.15:  # three planes, 1 x 1
        return fx.tiff_bytes(r.integers(0, 256, (h, w, 3)), photometric=6, compression=int(r.choice([5, 8])),
                             planar=2, predictor=2, tags={530: (3, [1, 1])},
                             **({"tile": (16, 16)} if tiled else {"rows_per_strip": int(r.integers(1, h + 1))}), **kw)
    hs, vs = SAMPLINGS[int(r.integers(len(SAMPLINGS)))]
    if tiled:
        kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))
    else:
        kw["rows_per_strip"] = vs * int(r.integers(1, -(-h // vs) + 1))
    return fx.ycbcr_predictor_tiff(r, h, w, hs, vs, int(r.choice([5, 8, 32946, 32773])), **kw)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_jpeg_planes_and_ycbcr_predictor_tiffs_match_pillow(tmp_path, seed):
    """60 seeded files a seed: each decodes to Pillow's RGB, or where
    Pillow refuses it (subsampled YCbCr planes) the port raises naming the
    file."""
    r = np.random.default_rng(2090 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"t{t}.bmp", _seeded_planes_or_predictor(r)), f"file {t}")
                  for t in range(60))
    assert decoded > 45


@pytest.mark.parametrize("quality", [40, 95])
@pytest.mark.parametrize("mode", ["L", "RGB", "YCbCr", "CMYK"])
def test_pillow_written_jpeg_tiff_matches_pillow(tmp_path, mode, quality):
    """Pillow's writer (libtiff's JPEG codec: JPEGTables, one strip a few
    rows tall, photometric 1, 2, 6 with YCbCrSubsampling 1 x 1, and 5)."""
    img = fx.smooth_scene(1910, 45, 38, cell=8, step=4)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).convert(mode).save(path, format="TIFF", compression="tiff_jpeg", quality=quality)
    with Image.open(path) as im:
        assert im.tag_v2[259] == 7 and 347 in im.tag_v2
    assert _same_as_pillow(path, f"{mode} q{quality}")


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    """The system libjpeg's writer, built once for the session's workers."""
    return fx.jpeg_writer(str(tmp_path_factory.getbasetemp().parent / "jpeg_writer"))


@pytest.mark.parametrize("sampling", [(4, 1), (1, 2), (4, 2), (2, 2)])
def test_libjpeg_written_ycbcr_jpeg_tiff_matches_pillow(tmp_path, writer, sampling):
    """Streams the system libjpeg writes at luma factors Pillow's writer
    does not offer, in strips of 11 rows and in tiles."""
    lib = writer
    img = fx.smooth_scene(1911, 27, 35, cell=8, step=4)

    def encode(block):
        path = str(tmp_path / "s.jpg")
        fx.libjpeg_file(lib, block, path, sampling=[sampling, (1, 1), (1, 1)], quality=85)
        with open(path, "rb") as f:
            return f.read()

    for kw in ({"rows_per_strip": 11}, {"tile": (16, 32)}):
        data = fx.jpeg_tiff(img, 6, sampling=sampling, encode=encode, **kw)
        assert _same_as_pillow(_write(tmp_path, "t.png", data), f"{sampling} {kw}")


def _seeded(r) -> tuple:
    """A JPEG or YCbCr TIFF over the layouts' parameters together: kind,
    size, byte order, strips or tiles, tables, sampling tag, quality,
    compression, subsampling, coefficients, orientation; beside it whether
    its data may be short of what the tags say (YCbCr blocks of other than
    libtiff's default 2 x 2 without the tag)."""
    h, w = int(r.integers(1, 48)), int(r.integers(1, 48))
    kw = {"order": "<" if r.random() < 0.6 else ">"}
    if r.random() < 0.3:
        kw["orientation"] = int(r.integers(1, 9))
    if r.random() < 0.5:  # JPEG
        photometric = int(r.choice([0, 1, 2, 5, 6, 6, 6]))
        img = fx.smooth_scene(int(r.integers(1 << 30)), h, w, cell=8, step=int(r.integers(1, 8)))
        samples = {0: img[..., 0], 1: img[..., 1], 2: img, 6: img}.get(photometric)
        if photometric == 5:
            samples = np.concatenate([img, img.min(axis=2, keepdims=True) // 2], 2)
        sampling = tuple(map(int, r.choice([(1, 1), (2, 1), (2, 2)])))
        if r.random() < 0.5:
            kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))
        else:
            kw["rows_per_strip"] = int(r.integers(1, h + 1))
            kw["full_last"] = r.random() < 0.3
        tag = "stream" if r.random() < 0.8 else None
        return fx.jpeg_tiff(samples, photometric, int(r.integers(5, 101)), sampling, tables=r.random() < 0.7,
                            sampling_tag=tag, **kw), False
    hs, vs = SAMPLINGS[int(r.integers(len(SAMPLINGS)))]
    comp = int(r.choice([5, 8, 32946, 32773]))
    if r.random() < 0.5:
        kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))
    else:
        kw["rows_per_strip"] = vs * int(r.integers(1, -(-h // vs) + 1))
    tags = {}
    if r.random() < 0.3:
        tags[529] = (5, [int(v) for v in r.integers(1, 1000, 3) for v in (v, 1000)])
    if r.random() < 0.3:
        tags[532] = (5, [int(v) for v in r.integers(0, 300, 6) for v in (v, 1)])
    tagged = r.random() < 0.9
    return fx.ycbcr_tiff(*fx.ycbcr_planes(r, h, w, hs, vs), hs, vs, comp, sampling_tag=tagged, tags=tags,
                         **kw), not tagged and (hs, vs) != (2, 2)


def _same_or_short(path: str, what: str) -> bool:
    """A file whose data may be short of its tags: the port reads it as
    Pillow does, or refuses it as data that break the format's rules, naming
    the file (libtiff's decoder fails there and Pillow's TIFFRGBAImage call,
    which does not stop on errors, shows zeros where data were missing)."""
    want = _pillow(path)
    try:
        got = images.read_image(path)
    except OSError as e:
        assert path in str(e) and "breaks the format's rules" in str(e), str(e)
        return False
    np.testing.assert_array_equal(got, want, err_msg=what)
    return True


@pytest.mark.parametrize("seed", range(3))
def test_seeded_jpeg_and_ycbcr_tiffs_match_pillow(tmp_path, seed):
    """100 seeded files a case: each decodes to Pillow's RGB, or where
    Pillow refuses it (a sampling tag the stream does not have, a
    coefficient of green 0...) the port raises naming the file; files
    whose data may be short, ``_same_or_short``."""
    r = np.random.default_rng(1912 + seed)
    decoded = 0
    for t in range(100):
        data, short = _seeded(r)
        path = _write(tmp_path, f"t{t}.png", data)
        decoded += _same_or_short(path, f"file {t}") if short else _same_as_pillow(path, f"file {t}")
    assert decoded > 80


def _originals(root: str) -> str:
    """Small originals under listed names: YCbCr 2 x 2 and 2 x 1 JPEG TIFFs
    (.jpg, .png), a gray JPEG TIFF in tiles (.jpeg), an RGB JPEG TIFF
    (.bmp), YCbCr 4 x 2 Deflate (.png) and raw YCbCr in one-row strips
    (.webp), which Pillow reads four bytes a pixel into the next strip."""
    os.makedirs(root)
    img = fx.source_image(1913, 37, 45)
    r = np.random.default_rng(1914)
    data = {
        "a.jpg": fx.jpeg_tiff(img, 6, 85, (2, 2), rows_per_strip=16),
        "b.png": fx.jpeg_tiff(img, 6, 70, (2, 1), tile=(16, 32), order=">"),
        "c.jpeg": fx.jpeg_tiff(img[..., 0], 1, 90, tile=(32, 16)),
        "d.bmp": fx.jpeg_tiff(img, 2, 80, rows_per_strip=9, orientation=8),
        "e.png": fx.ycbcr_tiff(*fx.ycbcr_planes(r, 37, 45, 4, 2), 4, 2, 8, rows_per_strip=8),
        "f.webp": fx.tiff_bytes(r.integers(0, 256, (37, 45, 3)), photometric=6, rows_per_strip=1),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_jpeg_and_ycbcr_tiff_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of JPEG and YCbCr TIFF originals under
    listed names."""
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 6
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 24


def test_loader_reads_jpeg_and_ycbcr_tiffs_as_jax_pillow_fallback(tmp_path):
    """A prepared set of JPEG and YCbCr TIFFs under listed names: the
    port's loader reads each as the JAX package's ``StageDataset`` does
    through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(1915)
    for i in range(6):
        img = fx.smooth_scene(1916 + i, 16, 16, cell=4, step=4)
        data = (fx.jpeg_tiff(img, 6, 80, ((2, 2), (2, 1), (1, 1))[i % 3]) if i % 2 == 0 else
                fx.ycbcr_tiff(*fx.ycbcr_planes(r, 16, 16, 2, 2), 2, 2, (5, 32773, 8)[i % 3]))
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_as_jpeg_tiffs_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on a YCbCr JPEG TIFF and a YCbCr
    LZW TIFF at the stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(1917, 32, 32)
    r = np.random.default_rng(1918)
    paths = [_write(tmp_path, "face.tif", fx.jpeg_tiff(img, 6, 90, (2, 2), rows_per_strip=8)),
             _write(tmp_path, "face2.tiff", fx.ycbcr_tiff(*fx.ycbcr_planes(r, 32, 32, 2, 1), 2, 1))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
