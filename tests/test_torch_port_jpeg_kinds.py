"""The JPEG kinds that the JAX package's native lane refuses or reads otherwise, on the CPU.

The port's JPEG decoder (``native/jpeg_decode.cpp``, ``jpeg_arith.cpp``,
``jpeg_lossless.cpp``, through ``data/native.py``) reads them bit for bit
with the lane of the JAX package that reads them: 4:4:0 chroma and
arithmetic coding with both of its lanes (its native libjpeg-turbo 2.1.5
lane, built here from ``byogan_tpu/native/byogan_io.cpp``, and Pillow
12.1.0, which bundles libjpeg-turbo 3.1.3); progressive files left for
block smoothing (where the two lanes differ), CMYK, YCCK and lossless
(SOF3) files with its Pillow lane, which its prep, ``cli.project`` and the
loader's fallback read originals through.  The tolerance of every case is
0.  The files come from the system's libjpeg (``tests/
torch_port_jpeg_writer.c``: arithmetic coding, YCCK, CMYK without an Adobe
marker, 4:4:0), Pillow (CMYK, progressive) and the fixtures' own writers
(4:4:0 blocks, lossless).  Then the tables against libjpeg's and Pillow's,
the committed fixtures, the JAX package's prep and loader on the same
files, and threads.
"""

import concurrent.futures
import ctypes
import glob
import os
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.png import read_png
from byogan_tpu_torch.data.prep import prepare_pyramid

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


def _holds(path: str, jax_lane=None) -> np.ndarray:
    """The port's decode of ``path`` equal to Pillow's RGB and (``jax_lane``
    given) to the JAX native lane's, and ``read_image`` to it."""
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, fx.pil_rgb(path), err_msg=f"{path}: Pillow's lane")
    if jax_lane is not None:
        np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path), err_msg=f"{path}: the native lane")
    np.testing.assert_array_equal(images.read_image(path, got.shape[:2]), got)
    return got


PHOTO = fx.source_image(501, 37, 45)

# --- 4:4:0 ------------------------------------------------------------------

# (h, v) factors: luma 1x2 over chroma 1x1, 2x2 over 2x1 (both rh 1, rv 2:
# h1v2_fancy_upsample), and 1x4 over 1x2 (the same filter at other factors)
SAMPLINGS_440 = {"1x2": [(1, 2), (1, 1), (1, 1)], "2x2-over-2x1": [(2, 2), (2, 1), (2, 1)],
                 "1x4-over-1x2": [(1, 4), (1, 2), (1, 2)]}
CASES_440 = [(k, s) for k in SAMPLINGS_440 for s in ((1, 1), (5, 3), (17, 33), (40, 71))]


@pytest.mark.parametrize("kind,size", CASES_440, ids=[f"{k}-{s[0]}x{s[1]}" for k, s in CASES_440])
def test_440_matches_both_lanes(tmp_path, jax_lane, kind, size):
    """4:4:0 chroma at odd sizes: h1v2_fancy_upsample's vertical triangle
    filter (bias 1 above, 2 below), the edges' rows repeated."""
    data = fx.jpeg_from_blocks(*size, SAMPLINGS_440[kind], seed=size[0] * 13 + size[1])
    _holds(_write(tmp_path, "a.jpg", data), jax_lane)


def test_440_from_libjpeg_and_quarter_ratio_boxes(tmp_path, jax_lane, writer):
    """libjpeg's own 4:4:0 file of a photo, and luma 1x4 over chroma 1x1
    (rv 4: int_upsample's boxes, not the triangle filter)."""
    _holds(_write(tmp_path, "lj.jpg", fx.libjpeg_file(writer, PHOTO, str(tmp_path / "w.jpg"), quality=90,
                                                      sampling=[(1, 2), (1, 1), (1, 1)])), jax_lane)
    _holds(_write(tmp_path, "q.jpg", fx.jpeg_from_blocks(23, 19, [(1, 4), (1, 1), (1, 1)], seed=9)), jax_lane)


# --- arithmetic coding --------------------------------------------------------

ARITH_SAMPLINGS = {"gray": None, "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
                   "422": [(2, 1), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)]}
ARITH_VARIANTS = {"seq": dict(), "prog": dict(progressive=1), "seq-restarts": dict(restart_interval=2),
                  "prog-restarts": dict(progressive=1, restart_interval=1),
                  "seq-dac": dict(dc_l=3, dc_u=7, ac_k=30), "prog-dac": dict(progressive=1, dc_l=0, dc_u=0, ac_k=1)}
ARITH_CASES = [(s, v) for s in ARITH_SAMPLINGS for v in ARITH_VARIANTS]


def _arith_file(writer, tmp_path, sampling: str, variant: str, quality: int = 85) -> bytes:
    kw = dict(ARITH_VARIANTS[variant])
    img = PHOTO[..., :1] if sampling == "gray" else PHOTO
    space = "gray" if sampling == "gray" else "ycbcr"
    return fx.libjpeg_file(writer, img, str(tmp_path / "w.jpg"), space=space, arith=1, quality=quality,
                           sampling=ARITH_SAMPLINGS[sampling] or (), **kw)


@pytest.mark.parametrize("sampling,variant", ARITH_CASES, ids=[f"{s}-{v}" for s, v in ARITH_CASES])
def test_arithmetic_matches_both_lanes(tmp_path, jax_lane, writer, sampling, variant):
    """libjpeg's arithmetic coding (SOF9 sequential, SOF10 progressive):
    gray, 4:4:4, 4:2:0, 4:2:2 and 4:4:0, with restart intervals that
    reset the statistics and DAC markers of non-default L, U and Kx."""
    _holds(_write(tmp_path, "a.jpg", _arith_file(writer, tmp_path, sampling, variant)), jax_lane)


def _without_dac(data: bytes) -> bytes:
    """``data`` with its DAC markers taken out."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xCC:
            out += data[pos:end]
        pos = end
    at = data.index(b"\xff\xda", pos)
    while True:  # later DAC markers sit between scans
        nxt = data.find(b"\xff\xcc", at)
        if nxt < 0:
            return bytes(out + data[pos:])
        out += data[pos:nxt]
        pos = nxt + 2 + int.from_bytes(data[nxt + 2:nxt + 4], "big")
        at = pos


@pytest.mark.parametrize("variant", ["seq", "prog"])
def test_arithmetic_without_dac_takes_the_defaults(tmp_path, jax_lane, writer, variant):
    """A file with no DAC marker conditions on T.81's defaults (L 0, U 1,
    Kx 5), which are the values libjpeg wrote into its DAC markers."""
    data = _without_dac(_arith_file(writer, tmp_path, "420", variant))
    assert b"\xff\xcc" not in data[:data.index(b"\xff\xda")]
    _holds(_write(tmp_path, "a.jpg", data), jax_lane)


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_arithmetic_at_qualities(tmp_path, jax_lane, writer, quality):
    """Magnitudes of every size: quality 1 (large DC steps, few AC) to 100
    (every coefficient, the AC statistics past Kx)."""
    for variant in ("seq", "prog"):
        _holds(_write(tmp_path, f"{variant}.jpg", _arith_file(writer, tmp_path, "444", variant, quality)), jax_lane)


# --- block smoothing ---------------------------------------------------------

SMOOTH_KINDS = {"dc-only": lambda n, ss, se, ah, al: ss == 0, "no-refine": lambda n, ss, se, ah, al: ah == 0,
                "dc-first-only": lambda n, ss, se, ah, al: ss == 0 and ah == 0,
                "luma-ac-missing": lambda n, ss, se, ah, al: ss == 0 or n != 1}
SMOOTH_CASES = [(k, sub, size) for k in SMOOTH_KINDS for sub in (0, 2) for size in ((17, 33), (40, 48))] + [
    ("dc-only", 1, (100, 9)), ("no-refine", 2, (100, 9)), ("dc-only", 2, (8, 8)), ("no-refine", 0, (33, 130))]


@pytest.mark.parametrize("kind,sub,size", SMOOTH_CASES,
                         ids=[f"{k}-{('444', '422', '420')[s]}-{z[0]}x{z[1]}" for k, s, z in SMOOTH_CASES])
def test_block_smoothing_matches_pillow(tmp_path, kind, sub, size):
    """Progressive files whose scans leave coefficients of zigzag 1-9
    unfinished: only the DC (the 5 x 5 DC interpolation, DC included), the
    refinement scans missing (estimates kept below 2^Al), only the first
    DC scan, the luma's AC scans missing; 4:4:4, 4:2:2 and 4:2:0 (a
    vertically sampled component's rows counted as libjpeg-turbo 3.1.3
    counts them): Pillow's lane."""
    img = fx.source_image(size[0] * 3 + size[1], *size)
    prog = fx._pil_jpeg(img, quality=90, progressive=True, subsampling=sub)
    _holds(_write(tmp_path, "s.jpg", fx.drop_scans(prog, SMOOTH_KINDS[kind])))


def test_block_smoothing_of_arithmetic_and_unsmoothed_files(tmp_path, jax_lane, writer):
    """An arithmetic progressive file with its AC scans taken out is
    smoothed too (Pillow's lane); a whole progressive file and one whose
    quantisers of zigzag 0-9 include a 0 are not, in both lanes."""
    data = fx.drop_scans(_arith_file(writer, tmp_path, "444", "prog"), lambda n, ss, se, ah, al: ss == 0)
    _holds(_write(tmp_path, "a.jpg", data))
    _holds(_write(tmp_path, "whole.jpg", fx._pil_jpeg(PHOTO, quality=90, progressive=True)), jax_lane)


# --- CMYK and YCCK -------------------------------------------------------------

CMYK = fx.cmyk_of(PHOTO)
FOUR = {"cmyk-adobe": dict(space="cmyk"), "cmyk-no-adobe": dict(space="cmyk", adobe=0),
        "cmyk-adobe-420": dict(space="cmyk", sampling=[(2, 2), (1, 1), (1, 1), (2, 2)]),
        "cmyk-prog": dict(space="cmyk", progressive=1), "ycck-420": dict(space="ycck"),
        "ycck-444": dict(space="ycck", sampling=[(1, 1)] * 4), "ycck-prog-restarts": dict(space="ycck", progressive=1,
                                                                                          restart_interval=2),
        "ycck-arith": dict(space="ycck", arith=1), "ycck-422-k-half": dict(space="ycck", sampling=[(2, 1), (1, 1),
                                                                                                    (1, 1), (1, 1)])}


@pytest.mark.parametrize("kind", list(FOUR))
def test_cmyk_and_ycck_match_pillow(tmp_path, writer, kind):
    """Four components: CMYK with and without an Adobe marker (Pillow
    inverts both: rawmode "CMYK;I"), YCCK (Adobe transform 2:
    ycck_cmyk_convert), subsampled chroma with K full or half, progressive
    and arithmetic; then Pillow's cmyk2rgb."""
    _holds(_write(tmp_path, "c.jpg", fx.libjpeg_file(writer, CMYK, str(tmp_path / "w.jpg"), quality=90,
                                                     **FOUR[kind])))


@pytest.mark.parametrize("transform", [0, 1, 2, 7])
def test_four_components_follow_the_adobe_transform(tmp_path, writer, transform):
    """An Adobe marker's transform on a 4-component file: 0 is CMYK, any
    other YCCK (jdapimin.c's default_decompress_parms)."""
    data = bytearray(fx.libjpeg_file(writer, CMYK, str(tmp_path / "w.jpg"), space="ycck", quality=90))
    data[data.index(b"Adobe") + 11] = transform
    _holds(_write(tmp_path, "t.jpg", bytes(data)))


def test_pillow_cmyk_save(tmp_path):
    """Pillow's own CMYK JPEG (``Image.save`` of a CMYK image: Adobe
    marker, inverted samples), of a photo and of RGB converted by Pillow."""
    for i, im in enumerate((Image.fromarray(CMYK, "CMYK"), Image.fromarray(PHOTO).convert("CMYK"))):
        path = str(tmp_path / f"p{i}.jpg")
        im.save(path, quality=85)
        _holds(path)


def test_cmyk2rgb_is_pillows_exhaustively():
    """Every (C, M or Y, K) pair of samples, from the committed lossless
    CMYK fixture (no rounding on the way): the port's RGB equals Pillow's
    ``convert("RGB")`` of the same samples inverted (its cmyk2rgb on
    rawmode "CMYK;I"), and Pillow's decode of the file."""
    path = os.path.join(fx.FIXTURES, fx.KINDS, "lossless-cmyk-pairs.jpg")
    y, x = np.mgrid[0:256, 0:256]
    pairs = np.stack([x, 255 - x, (x + y) % 256, y], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("CMYK", (256, 256), (255 - pairs).tobytes()).convert("RGB"))
    np.testing.assert_array_equal(_holds(path), want)


# --- lossless -----------------------------------------------------------------

LOSSLESS_CASES = [(c, p, pt) for c in (1, 3) for p in range(1, 8) for pt in (0, 2)]


@pytest.mark.parametrize("comps,psv,pt", LOSSLESS_CASES, ids=[f"c{c}-p{p}-pt{t}" for c, p, t in LOSSLESS_CASES])
def test_lossless_matches_pillow(tmp_path, comps, psv, pt):
    """SOF3 with each predictor 1-7 and point transforms 0 and 2, gray and
    RGB, a restart interval of 3 MCU rows: Pillow's lane, and the samples
    themselves (the point transform's low bits cleared)."""
    planes = [PHOTO[..., c] for c in range(comps)]
    data = fx.jpeg_lossless(planes, psv, pt=pt, restart_rows=3)
    got = _holds(_write(tmp_path, "l.jpg", data))
    want = (PHOTO[..., :comps] >> pt << pt).astype(np.uint8)
    np.testing.assert_array_equal(got, np.repeat(want, 3 // comps, axis=2))


LOSSLESS_OTHERS = {
    "wrap": dict(psv=6, wrap=((0, 0, 0), (1, 5, 7), (2, 36, 44), (0, 20, 0))),
    "420-p7": dict(psv=7, sampling=[(2, 2), (1, 1), (1, 1)]),
    "422-p2-restarts": dict(psv=2, sampling=[(2, 1), (1, 1), (1, 1)], restart_rows=2),
    "adobe-rgb": dict(psv=1, adobe=0),
    "ids-rgb": dict(psv=4, ids=[ord("R"), ord("G"), ord("B")]),
    "ids-other": dict(psv=3, ids=[7, 8, 9]),
    "restart-every-row": dict(psv=5, restart_rows=1, pt=1),
}


@pytest.mark.parametrize("kind", list(LOSSLESS_OTHERS))
def test_lossless_variants_match_pillow(tmp_path, kind):
    """The category-16 difference (32768, wrapping modulo 2^16), 4:2:0 and
    4:2:2 chroma (boxes: a lossless frame has no triangle filter), restarts
    every row, and the colour space libjpeg-turbo assumes for 3 lossless
    components: RGB without a JFIF marker, whatever the component ids."""
    kw = dict(LOSSLESS_OTHERS[kind])
    planes = [PHOTO[..., c] for c in range(3)]
    if "sampling" in kw:
        rh, rv = kw["sampling"][0]
        planes = [planes[0], planes[1][::rv, ::rh], planes[2][::rv, ::rh]]
    _holds(_write(tmp_path, "l.jpg", fx.jpeg_lossless(planes, kw.pop("psv"), **kw)))


def test_lossless_refusals_are_pillows(tmp_path):
    """What Pillow 12.1.0 refuses the port refuses (``test_torch_port_codecs``
    names each fault): precisions other than 8 bits, lossless arithmetic
    (SOF11), and YCbCr (JFIF, Adobe transform 1), which libjpeg-turbo would
    have to convert."""
    planes = [PHOTO[..., c] for c in range(3)]
    sof11 = bytearray(fx.jpeg_lossless(planes, 1))
    sof11[sof11.index(b"\xff\xc3") + 1] = 0xCB
    files = {"p2": fx.jpeg_lossless(planes[:1], 1, precision=2), "p12": fx.jpeg_lossless(planes[:1], 1, precision=12),
             "p16": fx.jpeg_lossless(planes[:1], 1, precision=16), "sof11": bytes(sof11),
             "jfif": fx.jpeg_lossless(planes, 1, jfif=True), "adobe-ycc": fx.jpeg_lossless(planes, 1, adobe=1)}
    for name, data in files.items():
        path = _write(tmp_path, f"{name}.jpg", data)
        with pytest.raises(Exception):
            fx.pil_rgb(path)
        with pytest.raises(OSError, match="lossless frame"):
            native.decode_image(path)


# --- the tables ---------------------------------------------------------------


@pytest.mark.parametrize("which", ["system", "pillow"])
def test_aritab_is_libjpegs(which):
    """``jpeg_arith.cpp``'s state table equals ``jpeg_aritab`` in libjpeg's
    binary: the system's (libjpeg-turbo 2.1.5) and Pillow's (3.1.3).  A
    wrong entry shows only on files whose statistics reach it."""
    path = ("libjpeg.so.62" if which == "system"
            else glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)), "pillow.libs",
                                        "libjpeg-*.so*"))[0])
    theirs = list((ctypes.c_long * 114).in_dll(ctypes.CDLL(path), "jpeg_aritab"))
    ours = list((ctypes.c_int32 * 114).in_dll(native.load_library(), "_ZN6byogan4jpeg7kAriTabE"))
    assert ours == theirs


# --- the fixtures -------------------------------------------------------------


def test_kinds_fixtures_are_what_the_writers_make(tmp_path):
    """The committed files of the kinds are what ``kinds_fixtures`` writes
    here (the system's libjpeg, Pillow, the lossless writer), and they
    hold each kind in the card's originals and every stage's size."""
    made = fx.kinds_fixtures(str(tmp_path))
    committed = fx.committed_kinds()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    for kind in fx.JPEG_KINDS:
        assert any(fx.kind_of(n) == kind for n in committed if "/card/" in n), kind
        for size in fx.WEBP_TRAIN_SIZES:
            assert f"{fx.KINDS}/train/{size}-{kind}.jpg" in committed
    assert sum(map(len, committed.values())) < 1_500_000


def test_committed_kinds_decode_to_their_hashes():
    """What ``chip_smoke.py`` checks on the card's machine: every committed
    file of the kinds decodes to its manifest hash (Pillow's RGB), and the
    manifest records what the JAX native lane does with it: the 4:4:0 and
    arithmetic files alike, CMYK, YCCK and lossless refused, block
    smoothing apart where a component is sampled vertically."""
    manifest = fx.load_manifest()
    names = [n for n in manifest["files"] if n.startswith(f"{fx.KINDS}/")]
    assert sorted(names) == sorted(fx.committed_kinds())
    for name in names:
        want = manifest["files"][name]
        assert fx.sha256(native.decode_image(os.path.join(fx.FIXTURES, name))) == want["sha256_rgb"], name
        lane = want["native_lane"]
        kind = fx.kind_of(name)
        if kind in fx.BOTH_LANES:
            assert lane == "same", name
        elif kind in ("cmyk", "ycck", "lossless"):
            assert lane == "-4", name
    apart = manifest["files"][f"{fx.KINDS}/smooth-dc-only-420.jpg"]["native_lane"]
    assert apart["samples_apart"] > 0
    assert manifest["files"][f"{fx.KINDS}/smooth-dc-only-444.jpg"]["native_lane"] == "same"


# --- the JAX package's functions on the same files ----------------------------


def test_prepare_pyramid_on_the_kinds_matches_jax(tmp_path):
    """The port's ``prepare_pyramid`` on the card's originals of the kinds
    (1024 px; lossless 512 px): every image of every set equals the JAX
    package's (Pillow's decode and bilinear resize, digests in the
    manifest)."""
    root = tmp_path / "kinds"
    root.mkdir()
    committed = fx.committed_kinds()
    for name in fx.KINDS_CARD:
        (root / name).write_bytes(committed[f"{fx.KINDS}/card/{name}"])
    prepare_pyramid(str(root), 4, 512, workers=4, device="cpu")
    assert fx.check_prep(str(root), read_png, "jpeg_prep") == 8 * len(fx.KINDS_CARD)


def test_stage_dataset_with_the_kinds_matches_jax(tmp_path):
    """A prepared 16 px set holding a file of each kind beside PNGs: the
    port's ``StageDataset`` counts and decodes it as JAX's does on its
    Pillow lane."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(fx.smooth_scene(60 + i, 16, 16, cell=4)).save(folder / f"image-{i}.png")
    for i, kind in enumerate(fx.JPEG_KINDS):
        (folder / f"image-{i + 2}.jpg").write_bytes(fx.committed_kinds()[f"{fx.KINDS}/train/16-{kind}.jpg"])
    idx = np.array([8, 0, 3, 1, 2, 5, 4, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        jds = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0)
        want = jds.get_batch_uint8(idx, workers=2)
    pds = port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0)
    assert len(pds) == len(jds) == 2 + len(fx.JPEG_KINDS)
    np.testing.assert_array_equal(pds.get_batch_uint8(idx, 3), want)


def test_project_load_target_reads_the_kinds_as_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on a file of each kind at the
    stage's size: the pixels the JAX CLI loads (Pillow's convert("RGB"))."""
    from byogan_tpu_torch.cli.project import load_target

    for kind in fx.JPEG_KINDS:
        path = os.path.join(fx.FIXTURES, fx.KINDS, "train", f"32-{kind}.jpg")
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=kind)


# --- threads ----------------------------------------------------------------


def test_eight_threads_equal_one(tmp_path):
    """The loader's threads decode at once, and no decoder keeps state:
    8 threads over every committed file of the kinds give each file's one
    thread result."""
    paths = [os.path.join(fx.FIXTURES, n) for n in fx.committed_kinds() if "/card/" not in n]
    paths += [os.path.join(fx.FIXTURES, fx.KINDS, "card", n) for n in ("arith-prog-1024.jpg", "smoothed-1024.jpg")]
    work = paths * 3
    one = [native.decode_image(p) for p in work]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        many = list(pool.map(native.decode_image, work))
    for p, a, b in zip(work, one, many):
        np.testing.assert_array_equal(a, b, err_msg=p)
