"""Where the JAX package's lanes read image files otherwise, on the CPU.

The JAX package decodes originals (its prep, ``cli.project``) through
Pillow's ``Image.open(path).convert("RGB")`` and a prepared set (its
loader) through its native libpng/libjpeg-turbo lane.  The port's
``read_image`` takes the lane as an argument: "pillow" for originals,
"native" for the loader.  Held here, bit for bit:

- every PNG colour type x bit depth x tRNS x Adam7 in both lanes: the
  Pillow lane against Pillow 12.1.0, the native lane against the JAX
  native lane (built from ``byogan_tpu/native/byogan_io.cpp`` into the
  tests' own directory).  Only 16-bit gray parts them: libpng keeps the
  high byte, Pillow's I;16 -> RGB clips the sample at 255;
- JPEGs whose dequantised coefficients leave 16 bits, of every kind that
  shares the IDCT (baseline, progressive, arithmetic, block-smoothed,
  4:2:0, 4:4:4, gray), against Pillow and the JAX native lane, which both
  run libjpeg-turbo's 16-bit SIMD IDCT (block smoothing: Pillow alone, as
  the lanes differ there);
- the committed files under ``pillow/`` against their writers and their
  manifest; the port's ``cli.prep``, loader and ``cli.project`` against
  the JAX package's on BMP and 16-bit gray originals.
"""

import os
import struct
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.png import read_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402


@pytest.fixture(scope="session")
def jax_lane(tmp_path_factory):
    """JAX's libpng/libjpeg lane, built once for all of the session's workers."""
    return fx.jax_lane(str(tmp_path_factory.getbasetemp().parent / "jax_native_lane"))


@pytest.fixture(scope="session")
def writer(tmp_path_factory):
    """The system libjpeg's writer, built once for all of the session's workers."""
    return fx.jpeg_writer(str(tmp_path_factory.getbasetemp().parent / "jpeg_writer"))


def _write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# --- PNG: every kind in both lanes --------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PNG_CASES = [(c, d, t, i) for c, ds in DEPTHS.items() for d in ds
             for t in ((False, True) if c in (0, 2, 3) else (False,)) for i in (False, True)]


@pytest.mark.parametrize("color,depth,trns,interlace", PNG_CASES,
                         ids=[f"c{c}-{d}bit{'-trns' if t else ''}{'-adam7' if i else ''}" for c, d, t, i in PNG_CASES])
def test_png_lanes(tmp_path, jax_lane, color, depth, trns, interlace):
    """The Pillow lane gives Pillow's ``convert("RGB")``, the native lane
    the JAX native lane's RGB; they differ only on 16-bit gray, where a
    sample above 255 reads as 255 and as its high byte."""
    r = np.random.default_rng(color * 100 + depth)
    top = 1 << depth
    samples = r.integers(0, top, (13, 11, CHANNELS[color]))
    if color == 0 and depth == 16:
        samples[0, :6, 0] = [0, 255, 256, 771, 1542, 65535]
    chunks = []
    if color == 3:  # a palette shorter than the indices reach: black past its end in both
        chunks.append((b"PLTE", bytes(r.integers(0, 256, 3 * max(1, top // 2), dtype=np.uint8))))
    if trns:
        value = samples[0, 0]
        chunks.append((b"tRNS", bytes([0, 128]) if color == 3 else struct.pack(f">{len(value)}H", *value)))
    path = _write(tmp_path, "a.png", fx.png_bytes(samples, depth, color, interlace, chunks))
    pil = fx.pil_rgb(path)
    native = fx.jax_decode(jax_lane, path)
    np.testing.assert_array_equal(images.read_image(path, lane="pillow"), pil)
    np.testing.assert_array_equal(images.read_image(path), native)
    np.testing.assert_array_equal(images.read_image(path, native.shape[:2]), native)
    if color == 0 and depth == 16:
        v = samples[..., 0]
        np.testing.assert_array_equal(pil[..., 0], np.minimum(v, 255))
        np.testing.assert_array_equal(native[..., 0], v >> 8)
    else:
        np.testing.assert_array_equal(pil, native)


def test_unknown_lane_raises(tmp_path):
    path = _write(tmp_path, "a.png", fx.png_bytes(np.zeros((2, 2, 1), np.int64), 16, 0))
    with pytest.raises(KeyError):
        images.read_image(path, lane="libpng")


# --- JPEG: dequantised coefficients past 16 bits ------------------------------


@pytest.mark.parametrize("kind", sorted(fx.IDCT_KINDS))
@pytest.mark.parametrize("seed", (1, 2))
def test_wide_coefficients_match_libjpeg_turbo(tmp_path, writer, jax_lane, kind, seed):
    """Blocks whose dequantised coefficients leave 16 bits (quantisers up
    to 255, DC up to +-2047, AC up to +-1023) beside blocks in range, of
    every kind that shares the IDCT: Pillow's RGB and the JAX native
    lane's (libjpeg-turbo's SIMD IDCT in both)."""
    sampling, arith, progressive, smoothed = fx.IDCT_KINDS[kind]
    h, w = 24 + 7 * seed, 40 - 5 * seed
    quant, coefs = fx.wide_blocks(1700 + 10 * seed + sorted(fx.IDCT_KINDS).index(kind), h, w, sampling)
    data = fx.coefficient_jpeg(writer, str(tmp_path / "w.jpg"), h, w, sampling, quant, coefs, arith, progressive)
    if smoothed:
        data = fx.drop_scans(data, lambda n, ss, se, ah, al: ah == 0)
    path = _write(tmp_path, "a.jpg", data)
    got = images.read_image(path)
    np.testing.assert_array_equal(got, fx.pil_rgb(path))
    if not smoothed:
        np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))


# (name, DC, an AC term (place, value), quantiser of every term): one gray block each
BLOCKS = {
    "dc-only-shift-wraps": (1200, None, 100),  # the all-AC-zero shortcut's DC << 2 in 16 bits
    "dc-only-product-wraps": (2047, None, 255),  # the dequantisation product in 16 bits
    "dc-beside-ac-saturates": (2047, (1, 1), 16),  # pass 1 packed with saturation
    "ac-dequantised-to-zero": (1200, (9, 256), 256),  # 256 x 256 wraps to 0, yet the shortcut is not taken
    "sums-in-16-bits": (0, (27, 1023), 120),  # in0 + in4, in7 + in3... in 16 bits
    "final-pack-saturates": (600, None, 8),  # x + 128 clamped, not masked
    "final-pack-saturates-in-64-bits": (1450, (1, 1023), 2),  # columns in range, a sample past 511
    "in-range": (40, (2, -30), 10),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_single_blocks_at_the_16_bit_limits(tmp_path, writer, jax_lane, name):
    """One block at each place where the 16-bit SIMD IDCT parts from
    jidctint.c's 64 bits: Pillow's samples and the JAX native lane's."""
    dc, ac, q = BLOCKS[name]
    coef = np.zeros((1, 1, 64), np.int16)
    coef[0, 0, 0] = dc
    if ac is not None:
        coef[0, 0, ac[0]] = ac[1]
    data = fx.coefficient_jpeg(writer, str(tmp_path / "b.jpg"), 8, 8, [(1, 1)], np.full((1, 64), q), [coef])
    path = _write(tmp_path, "b.jpg", data)
    got = images.read_image(path)
    np.testing.assert_array_equal(got, fx.pil_rgb(path))
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))


# --- the committed files ------------------------------------------------------


def test_pillow_fixtures_are_what_the_writers_make(tmp_path):
    """The committed files under ``pillow/`` are what ``pillow_fixtures``
    writes here (this module's BMP and PNG writers, the system libjpeg's
    coefficient writer), and the manifest records each: Pillow's RGB or
    its refusal, both lanes of each 16-bit gray PNG, and the native lane
    alike on every out-of-range JPEG but the block-smoothed one."""
    made = fx.pillow_fixtures(str(tmp_path))
    committed = fx.committed_pillow()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    files = fx.load_manifest()["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.PILLOW}/")) == sorted(committed)
    for name in committed:
        entry = files[name]
        if "/refused/" in name:
            assert "refused" in entry and entry["pillow"], name
        elif "/gray16/" in name or name.endswith(".png"):
            assert entry["sha256_rgb"] != entry["sha256_rgb_pillow"], name
        elif "/idct/" in name:
            assert entry["native_lane"] == "same" or "smoothed" in name, name
    assert files[f"{fx.PILLOW}/idct/smoothed-420.jpg"]["native_lane"] != "same"
    assert sum(map(len, committed.values())) < 1_600_000


# --- the JAX package's functions on the same files ----------------------------


def _originals(root, kinds=("palette", "rle4", "rgb16", "gray16", "gray16-adam7")) -> str:
    """Small originals of the Pillow lane's kinds: palette, RLE4 and 16-bit
    BMPs, 16-bit gray PNGs (10 bits of samples, one Adam7)."""
    os.makedirs(root)
    r = np.random.default_rng(1701)
    img = fx.source_image(1702, 37, 45)
    idx, palette = fx._quantised(img, 6)
    for kind in kinds:
        if kind == "palette":
            data = fx.bmp_file(fx.bmp_rows(idx, 8)[::-1].tobytes(), 45, 37, 8, palette=palette)
        elif kind == "rle4":
            data = fx.bmp_file(fx.rle_stream((idx % 16)[::-1], True), 45, 37, 4, compression=2, palette=palette[:16])
        elif kind == "rgb16":
            data = fx.bmp_file(fx.bmp_rows(r.integers(0, 65536, (30, 27)), 16)[::-1].tobytes(), 27, 30, 16)
        else:
            data = fx.png_bytes(r.integers(0, 1024, (33, 41, 1)), 16, 0, interlace=kind.endswith("adam7"))
        with open(os.path.join(root, f"{kind}.{'png' if kind.startswith('gray') else 'bmp'}"), "wb") as f:
            f.write(data)
    return root


def _same_sets(port_root: str, jax_root: str, sets: int) -> int:
    n = 0
    for k in range(1, sets + 1):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub)))
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    return n


def test_prep_cli_on_bmp_and_16_bit_gray_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` on palette, RLE4 and 16-bit BMP originals
    and 16-bit gray PNG scans: every level equals the JAX package's
    ``prepare_pyramid`` (Pillow's decode: the gray scans clipped at 255);
    then on the card's committed originals (a 1024 px palette BMP, RLE8
    BMP and 16-bit gray PNG) against the JAX package's recorded pyramid."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    from byogan_tpu_torch.cli import prep as port_prep_cli

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 32, workers=2)
    port_prep_cli.main([port_root, "4", "32", "-y", "-w", "2", "-d", "cpu"])
    assert _same_sets(port_root, jax_root, 4) == 4 * 5
    card = tmp_path / "card"
    card.mkdir()
    for name in fx.PILLOW_CARD:
        (card / name).write_bytes(fx.committed_pillow()[f"{fx.PILLOW}/card/{name}"])
    port_prep_cli.main([str(card), "4", "512", "-y", "-d", "cpu"])
    assert fx.check_prep(str(card), read_png, "pillow_prep") == 8 * len(fx.PILLOW_CARD)


def test_loader_reads_16_bit_gray_as_jax_stage_dataset(tmp_path, jax_lane):
    """A prepared set of 16-bit gray PNGs: the port's loader reads each
    sample's high byte, as JAX's ``StageDataset`` does on its native lane;
    and a set of the BMP layouts as its Pillow lane does."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(1703)
    for i in range(4):
        (folder / f"image-{i}.png").write_bytes(fx.png_bytes(r.integers(0, 65536, (16, 16, 1)), 16, 0,
                                                             interlace=i % 2 == 1))
    idx = np.array([2, 0, 3, 1])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: jax_lane):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    np.testing.assert_array_equal(port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, 2),
                                  want)
    assert (want > 0).any() and (want < 255).any()
    for f in folder.iterdir():
        f.unlink()
    layouts = {n: d for n, d in fx.bmp_layouts().items() if "rle8-" not in n and "rle4-" not in n}
    shapes = {n: Image.open(_write(tmp_path, "s.bmp", d)).size for n, d in layouts.items()}
    same = [n for n in layouts if shapes[n] == (13, 11)]
    for i, name in enumerate(same):
        (folder / f"image-{i}.bmp").write_bytes(layouts[name])
    idx = np.arange(len(same))[::-1].copy()
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):  # its Pillow lane: BMP
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    np.testing.assert_array_equal(port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, 3),
                                  want)
    assert len(same) > 40


def test_project_load_target_reads_bmp_and_16_bit_gray_as_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on files of the stage's size: the
    pixels the JAX CLI loads (Pillow's convert("RGB")), 16-bit gray clipped."""
    from byogan_tpu_torch.cli.project import load_target

    root = _originals(str(tmp_path / "o"), ("palette", "gray16"))
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        with Image.open(path) as im:
            res = im.size[1]
            want = np.asarray(im.convert("RGB").resize((res, res), Image.BILINEAR))
        if im.size == (res, res):
            np.testing.assert_array_equal(load_target(path, res), want, err_msg=name)
        got = images.read_image(path, lane="pillow")
        np.testing.assert_array_equal(got, fx.pil_rgb(path), err_msg=name)
    sq = _write(tmp_path, "sq.png", fx.png_bytes(np.random.default_rng(3).integers(0, 1024, (16, 16, 1)), 16, 0))
    np.testing.assert_array_equal(load_target(sq, 16), fx.pil_rgb(sq))
    bmp = fx.committed_pillow()[f"{fx.PILLOW}/bmp/pal8.bmp"]
    square = _write(tmp_path, "sq.bmp", fx.bmp_file(bmp[-16 * 16:], 16, 16, 8,
                                                    palette=np.random.default_rng(4).integers(0, 256, (256, 3))))
    np.testing.assert_array_equal(load_target(square, 16), fx.pil_rgb(square))
