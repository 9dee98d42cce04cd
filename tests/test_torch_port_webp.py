"""The port's own WebP decoder against the JAX package's Pillow lane, on the CPU.

The native library's WebP decoder (``native/webp.cpp``, ``vp8_decode.cpp``,
``vp8l_decode.cpp``, through ``data/native.py``) links zlib alone, so the
same code runs here and on the machine with the card, which has no Pillow
and no libwebp.  Its oracles here: Pillow (``Image.open(path).convert("RGB")``,
the JAX package's WebP lane: Pillow 12.1.0 with libwebp 1.6.0) for the RGB,
and the system's libwebp (``WebPDecodeYUV``, through ctypes) for the VP8
planes before the RGB conversion, so a fault shows in the decoder or in
the upsampler and colour matrix apart.  Every case is bit for bit.  Then
the JAX package's prep, loader and projection CLI on the same files, the
tables against libwebp's own, failures by name, and threads.
"""

import concurrent.futures
import glob
import os
import re
import struct
import sys
from unittest import mock

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from byogan_tpu_torch.data import images, native
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.png import read_png
from byogan_tpu_torch.data.prep import prepare_pyramid
from byogan_tpu_torch.native import build as native_build

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402


@pytest.fixture(scope="module")
def libwebp():
    return fx.libwebp()


def _write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _holds(path: str, lib=None) -> np.ndarray:
    """The port's decode of ``path`` equal to Pillow's RGB, and (``lib``
    given) its VP8 planes equal to libwebp's first."""
    if lib is not None:
        with open(path, "rb") as f:
            want = fx.webp_yuv(lib, f.read())
        for name, got, plane in zip("YUV", native.decode_vp8_yuv(path), want):
            np.testing.assert_array_equal(got, plane, err_msg=f"{path}: plane {name}")
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, fx.pil_rgb(path), err_msg=path)
    np.testing.assert_array_equal(images.read_image(path, got.shape[:2]), got)
    return got


# --- lossy ------------------------------------------------------------------

LOSSY_CASES = [(q, m, s) for q in (1, 50, 75, 95, 100) for m in (0, 6) for s in ((1, 1), (17, 33), (61, 50))] + [
    (75, 4, (300, 257))
]


@pytest.mark.parametrize("quality,method,size", LOSSY_CASES, ids=[f"q{q}-m{m}-{s[0]}x{s[1]}" for q, m, s in LOSSY_CASES])
def test_lossy_matches_pillow_and_libwebp_planes(tmp_path, libwebp, quality, method, size):
    """Pillow's lossy files (a bare VP8 chunk) at qualities 1-100, methods
    0 and 6, sizes 1x1, odd and above 256 px: the planes equal
    ``WebPDecodeYUV``'s, the RGB Pillow's."""
    img = fx.source_image(quality * 100 + size[1], *size)
    data = fx.pil_webp(img, quality=quality, method=method)
    assert data[12:16] == b"VP8 "
    _holds(_write(tmp_path, "a.webp", data), libwebp)


# The fixture writer's own VP8 files: what Pillow cannot ask libwebp for.
OWN_VARIANTS = {
    "simple-filter": dict(filter_type=0, filter_strength=60, autofilter=0),
    "simple-filter-sharp": dict(filter_type=0, filter_strength=100, filter_sharpness=5, autofilter=0),
    "segments-4": dict(segments=4, sns_strength=100),
    "segments-2-sharp": dict(segments=2, filter_sharpness=3, filter_strength=50),
    "partitions-8": dict(partitions=3),
    "partitions-2": dict(partitions=1, segments=3),
    "sharpness-7": dict(filter_type=1, filter_sharpness=7, filter_strength=80, autofilter=0),
    "strong-filter-100": dict(filter_type=1, filter_strength=100, autofilter=0),
    "filter-off": dict(filter_strength=0, autofilter=0),
    "autofilter": dict(autofilter=1, segments=4),
}
OWN_CASES = [(k, s) for k in OWN_VARIANTS for s in ((33, 47), (96, 80))]


@pytest.mark.parametrize("variant,size", OWN_CASES, ids=[f"{k}-{s[0]}x{s[1]}" for k, s in OWN_CASES])
def test_own_vp8_variants_match_pillow_and_libwebp_planes(tmp_path, libwebp, variant, size):
    """The simple and the normal loop filter at several levels and
    sharpnesses, the filter off, 2-4 segments, 2 and 8 token partitions."""
    img = fx.source_image(len(variant) * 10 + size[0], *size)
    data = fx.webp_encode(libwebp, img, 50, **OWN_VARIANTS[variant])
    _holds(_write(tmp_path, "own.webp", data), libwebp)


@pytest.mark.parametrize("kind", ["lossy", "lossy-exact", "lossy-ramp"])
def test_lossy_with_alpha_drops_it(tmp_path, libwebp, kind):
    """VP8X + ALPH + VP8 (Pillow's lossy RGBA): the alpha never changes
    the RGB, as in Pillow's RGBA lane."""
    img = fx.source_image(7, 37, 45)
    rgba = fx.with_alpha(img, None if kind == "lossy-ramp" else 11)
    data = fx.pil_webp(rgba, quality=80, exact=kind == "lossy-exact")
    assert data[12:16] == b"VP8X" and b"ALPH" in data
    _holds(_write(tmp_path, "alpha.webp", data), libwebp)


# --- lossless ---------------------------------------------------------------

LOSSLESS_CASES = {
    "photo-effort-0": lambda: fx.pil_webp(fx.source_image(1, 61, 50), lossless=True, quality=0, method=0),
    "photo-effort-100": lambda: fx.pil_webp(fx.source_image(2, 61, 50), lossless=True, quality=100, method=6),
    "smooth": lambda: fx.pil_webp(fx.smooth_scene(3, 70, 90, cell=16), lossless=True),
    "posterised": lambda: fx.pil_webp(fx.smooth_scene(4, 64, 64, cell=16, step=32), lossless=True),
    "palette-2": lambda: fx.pil_webp(fx.palette_image(5, 23, 37, 2), lossless=True),
    "palette-3": lambda: fx.pil_webp(fx.palette_image(6, 9, 11, 3), lossless=True),
    "palette-4": lambda: fx.pil_webp(fx.palette_image(7, 23, 37, 4), lossless=True),
    "palette-16": lambda: fx.pil_webp(fx.palette_image(8, 23, 37, 16), lossless=True),
    "palette-17": lambda: fx.pil_webp(fx.palette_image(9, 23, 37, 17), lossless=True),
    "palette-200": lambda: fx.pil_webp(fx.palette_image(10, 40, 44, 200), lossless=True),
    "rgba-exact": lambda: fx.pil_webp(fx.with_alpha(fx.source_image(11, 29, 31), 12), lossless=True, exact=True),
    "rgba": lambda: fx.pil_webp(fx.with_alpha(fx.source_image(13, 29, 31), 14), lossless=True),
    "1x1": lambda: fx.pil_webp(fx.source_image(15, 1, 1), lossless=True),
    "1x40": lambda: fx.pil_webp(fx.source_image(16, 1, 40), lossless=True),
    "noise": lambda: fx.pil_webp(np.random.default_rng(17).integers(0, 256, (33, 35, 3), dtype=np.uint8),
                                 lossless=True),
}


@pytest.mark.parametrize("kind", list(LOSSLESS_CASES))
def test_lossless_matches_pillow(tmp_path, kind):
    """VP8L of every transform: predictor, cross-colour and subtract-green
    (photo-like and smooth images at both efforts), colour indexing of 2-16
    colours bundled into pixels and of 17 and 200, RGBA with its RGB kept
    (exact) and not, 1x1 and one row."""
    data = LOSSLESS_CASES[kind]()
    assert data[12:16] in (b"VP8L", b"VP8X")
    _holds(_write(tmp_path, "ll.webp", data))


# --- animation --------------------------------------------------------------


def test_animations_draw_their_first_frame(tmp_path):
    """Pillow's animations (lossy and lossless frames: the first fills the
    canvas) and a hand-built one whose first frame, lossless, lies at
    (4, 6) on a 24x24 canvas: black outside it, its pixels inside, the
    ANIM background colour ignored; the second frame never drawn."""
    frames = [fx.smooth_scene(20 + i, 30, 40, cell=8) for i in range(3)]
    for kw in (dict(quality=60), dict(lossless=True)):
        _holds(_write(tmp_path, "anim.webp", fx.pil_webp_animation(frames, **kw)))
    first = fx.source_image(21, 16, 16)
    data = fx.webp_animation((24, 24), [(4, 6, fx.pil_webp(first, lossless=True)),
                                        (0, 0, fx.pil_webp(fx.source_image(22, 24, 24), quality=60))])
    got = _holds(_write(tmp_path, "offset.webp", data))
    np.testing.assert_array_equal(got[6:22, 4:20], first)
    outside = np.ones((24, 24), bool)
    outside[6:22, 4:20] = False
    assert not got[outside].any()


def test_committed_fixtures_decode_to_their_hashes():
    """The committed WebP fixtures (what ``chip_smoke.py`` checks on the
    card's machine): each file's RGB and, for the still lossy ones, its
    planes, to the manifest's hashes."""
    manifest = fx.load_manifest()
    names = [n for n in manifest["files"] if n.startswith(f"{fx.WEBP}/")]
    assert sorted(names) == sorted(fx.committed_webp()) and len(names) >= 20
    for name in names:
        want = manifest["files"][name]
        path = os.path.join(fx.FIXTURES, name)
        assert fx.sha256(native.decode_image(path)) == want["sha256_rgb"], name
        if "sha256_yuv" in want:
            assert fx.yuv_digest(native.decode_vp8_yuv(path)) == want["sha256_yuv"], name


# --- hypothesis -------------------------------------------------------------


@settings(max_examples=30, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16), quality=st.integers(0, 100),
       method=st.integers(0, 6), lossless=st.booleans(), smooth=st.booleans())
def test_random_images_match_pillow(tmp_path, h, w, seed, quality, method, lossless, smooth):
    img = fx.smooth_scene(seed, h, w, cell=8) if smooth else fx.source_image(seed, h, w)
    data = fx.pil_webp(img, quality=quality, method=method, lossless=lossless)
    _holds(_write(tmp_path, "h.webp", data))


# --- the tables -------------------------------------------------------------


def _cpp_table(src: str, name: str) -> bytes:
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    values = [int(v, 0) for v in re.findall(r"0x[0-9a-fA-F]+|\d+", body)]
    return struct.pack(f"<{len(values)}H", *values) if name == "kVp8AcTable" else bytes(values)


def _system_libwebp_path(lib) -> str:
    """The file the dynamic loader opened for ``libwebp.so.7``."""
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "/libwebp.so" in line}
    assert len(paths) == 1, paths
    return paths.pop()


@pytest.mark.parametrize("which", ["system", "pillow"])
def test_tables_are_libwebps(libwebp, which):
    """Every table of ``native/webp_tables.cpp`` is found, byte for byte,
    in libwebp's binary: the system's (1.2.4) and Pillow's (1.6.0).  A
    wrong entry would show only on files that reach it."""
    path = (_system_libwebp_path(libwebp) if which == "system"
            else glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)), "pillow.libs",
                                        "libwebp-*.so*"))[0])
    with open(path, "rb") as f:
        binary = f.read()
    with open(os.path.join(os.path.dirname(native_build.__file__), "webp_tables.cpp")) as f:
        src = f.read()
    names = re.findall(r"const uint(?:8|16)_t (k\w+)\[", src)
    assert len(names) == 12
    for name in names:
        assert binary.find(_cpp_table(src, name)) >= 0, f"{name} is not libwebp's"


# --- the JAX package's functions on the same files ----------------------------


def _originals(root: str) -> str:
    """WebP originals of every kind beside a PNG and a JPEG."""
    os.makedirs(root)
    put = lambda name, data: open(os.path.join(root, name), "wb").write(data)  # noqa: E731
    put("a.webp", fx.pil_webp(fx.source_image(31, 48, 40), quality=80))
    put("b.webp", fx.pil_webp(fx.source_image(32, 36, 52), lossless=True))
    put("c.webp", fx.pil_webp(fx.with_alpha(fx.source_image(33, 33, 35)), quality=70))
    put("d.webp", fx.webp_animation((40, 40), [(2, 4, fx.pil_webp(fx.source_image(34, 30, 30), lossless=True))]))
    Image.fromarray(fx.source_image(35, 40, 44)).save(os.path.join(root, "e.png"))
    Image.fromarray(fx.source_image(36, 44, 40)).save(os.path.join(root, "f.jpg"), quality=90)
    return root


def test_prepare_pyramid_on_webp_originals_matches_jax(tmp_path):
    """The port's ``prepare_pyramid`` on WebP originals (lossy, lossless,
    alpha, animated) beside a PNG and a JPEG: every set equals the JAX
    package's (Pillow's decode and resize), image for image."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 32, workers=2)
    prepare_pyramid(port_root, 4, 32, workers=2, device="cpu")
    for k in range(1, 5):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) == [f"image-{n}.png" for n in range(6)]
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")


def test_stage_dataset_with_webp_files_matches_jax(tmp_path):
    """A prepared set with a lossy and a lossless WebP beside its PNGs:
    the port's ``StageDataset`` counts and decodes them as JAX's does on
    its Pillow lane (its native lane refuses WebP)."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_2" / "images"
    folder.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(fx.smooth_scene(40 + i, 8, 8, cell=2)).save(folder / f"image-{i}.png")
    (folder / "image-3.webp").write_bytes(fx.pil_webp(fx.source_image(44, 8, 8), quality=70))
    (folder / "image-4.webp").write_bytes(fx.pil_webp(fx.source_image(45, 8, 8), lossless=True))
    idx = np.array([4, 0, 3, 1, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        jds = jax_pipe.StageDataset(str(root), 2, cache_limit_bytes=0)
        want = jds.get_batch_uint8(idx, workers=2)
    pds = port_pipe.StageDataset(str(root), 2, cache_limit_bytes=0)
    assert len(pds) == len(jds) == 5
    np.testing.assert_array_equal(pds.get_batch_uint8(idx, 3), want)


def test_project_load_target_reads_webp_as_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on WebP files already at the
    stage's size: the pixels the JAX CLI loads (byogan_tpu/cli/project.py:
    81-84, Pillow's convert("RGB"); no resize, whose filters differ by
    design)."""
    from byogan_tpu_torch.cli.project import load_target

    for name, data in (("l.webp", fx.pil_webp(fx.source_image(50, 16, 16), quality=85)),
                       ("ll.webp", fx.pil_webp(fx.source_image(51, 16, 16), lossless=True))):
        path = _write(tmp_path, name, data)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 16), want)


# --- failures ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(fx.webp_failures()))
def test_webp_failures_are_files_pillow_refuses(tmp_path, name):
    """The WebP failures that ``test_torch_port_codecs.py`` holds the port
    to (raising, naming the file and the reason) are files the JAX
    package's Pillow lane refuses too."""
    path = _write(tmp_path, f"{name}.webp", fx.webp_failures()[name][0])
    with pytest.raises(Exception):
        fx.pil_rgb(path)


# --- threads ----------------------------------------------------------------


def test_eight_threads_equal_one(tmp_path):
    """The loader's threads call the decoder at once: 8 threads over the
    committed WebP fixtures and a few larger files give each file's one
    thread result."""
    paths = [os.path.join(fx.FIXTURES, n) for n in fx.committed_webp()]
    big = fx.source_image(9, 200, 160)
    for i, kw in enumerate((dict(quality=80), dict(lossless=True), dict(quality=50, method=0))):
        paths.append(_write(tmp_path, f"big{i}.webp", fx.pil_webp(big, **kw)))
    work = paths * 4
    one = [native.decode_image(p) for p in work]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        many = list(pool.map(native.decode_image, work))
    for p, a, b in zip(work, one, many):
        np.testing.assert_array_equal(a, b, err_msg=p)
