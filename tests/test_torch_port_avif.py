"""The port's AVIF reader (its own AV1 intra decoder, intra block copy and
10- and 12-bit samples among its tools, and libavif's YUV-to-RGB) against
Pillow, libdav1d and the JAX package, on the CPU.

The JAX package reads an original under a listed extension through
``Image.open(path).convert("RGB")``: AVIF through Pillow 12.1.0's plugin
over libavif 1.3.0, dav1d 1.5.1 and libyuv, which the card's machine
lacks, so the port carries its own AV1 decoder (``native/av1_*.cpp``),
libavif's conversion (``native/avif_rgb.cpp``) and the container as
libavif parses it (``data/images.py``'s ``decode_avif``).  So every
committed layout of ``fx.avif_layouts`` (Pillow's encoder over aom's
settings, screen content aom codes with intra block copy, containers
written here around its streams, and 10- and 12-bit files the system's
libavif writes through ctypes, in this sandbox only) is held bit for bit
to Pillow's ``convert("RGB")`` in both of the port's lanes and, before the
conversion, to the planes (16-bit ones of 10- and 12-bit streams) the
system's libdav1d (1.0.0, through ctypes) decodes; each refusal (``fx.avif_refusals``) to its reason with the
file named; seeded damaged files to Pillow's pixels or verdict; the
committed layouts together to every partition, mode, palette size,
transform size and type and post-filter the decoder names.  Then AVIF
originals under listed names through the port's ``cli.prep`` against the
JAX package's ``prepare_pyramid``, its loader against the JAX loader's
Pillow fallback and ``cli.project`` targets against the JAX CLI's.
Tolerance 0.
"""

import io
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.avif_layouts()
REFUSALS = fx.avif_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
#: the refusals Pillow reads: the kinds the port leaves out by name
PILLOW_READS = ("sequence-no-primary-item.avif", "film-grain.avif", "qmatrix.avif", "superres.avif",
                "layered-a1lx.avif", "layered-lsel.avif", "nclx-ycgco-420.avif", "deep-10-ycgco-420.avif",
                "deep-12-fcc-422.avif")
#: the port's refusals by name of what Pillow may read (ROADMAP §3 fault 7's
#: AVIF queue, and frames libavif scales to their item's size)
BY_NAME = "is not read by the PyTorch port"
DAV1D = "libdav1d.so.6"


def _rgb(data: bytes):
    """Pillow's convert("RGB") of a file's bytes, or the exception it raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - OSError, ValueError, SyntaxError, RuntimeError and Pillow's own
        return e


def _sweep(files) -> dict:
    """``_held_to_pillow`` over many files, every file run: the names of
    those that fail it, and how many were read, refused and refused by
    name (a slow sweep's report)."""
    out = {"read": 0, "refused": 0, "by name": 0, "failed": []}
    for name, data in files:
        try:
            out[_held_to_pillow(data, name)] += 1
        except (AssertionError, OSError, pytest.fail.Exception) as e:
            out["failed"].append(f"{name}: {next((ln for ln in str(e).splitlines() if ln.strip()), '')[:160]}")
    return out


def _held_to_pillow(data: bytes, name: str) -> str:
    """The port's decode of ``data`` (``read_bytes``) against Pillow's:
    "read" where both read it to the same pixels, "refused" where both
    refuse it (the port naming ``name``), "by name" where the port refuses
    by name what Pillow reads."""
    want = _rgb(data)
    if isinstance(want, Exception):
        with pytest.raises(OSError, match=re.escape(name)):
            images.read_bytes(data, name)
        return "refused"
    try:
        got = images.read_bytes(data, name)
    except OSError as e:
        if BY_NAME in str(e):
            return "by name"
        raise
    np.testing.assert_array_equal(got, want, err_msg=name)
    return "read"


# --- the committed files ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


def test_layout_planes_match_libdav1d():
    """Before the colour conversion: each committed layout's AV1 streams
    (colour, and alpha where there is one) decode to the planes libdav1d
    decodes (16-bit ones of the 10- and 12-bit streams), every stream of
    them conforming."""
    try:
        dav1d = fx.Dav1dPicture(DAV1D)
    except OSError as e:
        pytest.skip(f"the loader finds no {DAV1D} ({e})")
    n = 0
    for name in sorted(LAYOUTS):
        hd = images._avif_open(LAYOUTS[name], name)
        for obus in (hd.color, hd.alpha):
            if obus is None:
                continue
            want = dav1d.planes(obus)
            assert not isinstance(want, int), f"{name}: libdav1d refuses it ({want})"
            for got, ref in zip(native.av1_planes(obus, name), want):
                assert (got is None) == (ref is None), name
                if ref is not None:
                    np.testing.assert_array_equal(got, ref, err_msg=name)
            n += 1
    assert n > len(LAYOUTS)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_the_verdict(tmp_path, name):
    """Each refusal names the file and its reason; Pillow refuses each too
    but the kinds the port leaves out by name that Pillow reads."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".jpg", data)
    reads = not isinstance(_pillow(path), Exception)
    assert reads == (name in PILLOW_READS), name
    for lane in ("native", "pillow"):
        with pytest.raises(OSError, match=f"{re.escape(path)}.*({reason})"):
            images.read_image(path, lane=lane)


def test_ftyp_without_meta_is_held_to_pillows_verdict(tmp_path):
    """An ftyp box of the avif brand and nothing after it (the AVIF case
    ``test_torch_port_dds_blp_ftex_icns_sun.py`` once refused by name):
    Pillow cannot identify it, and the port raises naming the file."""
    path = _write(tmp_path, "q.png", b"\0\0\0\x1cftypavif" + bytes(60))
    assert isinstance(_pillow(path), Exception)
    assert images.identify(path) == "AVIF"
    with pytest.raises(OSError, match=re.escape(path) + ".*(does not identify|unknown format)"):
        images.read_image(path)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``avif/`` are what ``avif_fixtures``
    writes here (Pillow's encoder and this module's container writer), and
    the manifest records each (Pillow's RGB, or the reason beside Pillow's
    verdict); the card's listed originals are in the JAX package's prep of
    every slice's originals of the Pillow lane (``PILLOW_LANE_PREP``)."""
    made = fx.avif_fixtures()
    committed = fx.committed_avif()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.AVIF}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    listed = sorted(v for v in fx.AVIF_CARD.values() if v)
    part = fx.pillow_lane_images(listed)
    assert len(part) == len(listed) and len(manifest[fx.PILLOW_LANE_PREP]) == 8
    assert all(set(part) <= set(d) for d in manifest[fx.PILLOW_LANE_PREP].values())
    assert sum(len(v) for v in committed.values()) < 600_000


def test_committed_fixtures_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on this folder: each file decodes
    to the manifest's RGB in both lanes, each refusal raises its reason."""
    files = fx.load_manifest()["files"]
    n = 0
    for name, want in sorted(files.items()):
        if not name.startswith(f"{fx.AVIF}/") or name.startswith(f"{fx.AVIF}/card/"):
            continue
        path = os.path.join(fx.FIXTURES, name)
        if "refused" in want:
            with pytest.raises(OSError, match=want["refused"]):
                images.read_image(path)
            continue
        for lane in ("native", "pillow"):
            got = images.read_image(path, lane=lane)
            assert list(got.shape[:2]) == want["shape"] and fx.sha256(got) == want["sha256_rgb"], name
        n += 1
    assert n >= 100


def test_card_originals_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: each is the manifest's bytes and decodes to Pillow's RGB."""
    assert sorted(fx.check_avif_card(images.read_image)) == sorted(fx.AVIF_CARD)


def test_committed_layouts_meet_every_syntax_value():
    """From the decoder's counts (``native.AV1_COUNTS``), the committed
    layouts together meet every partition type, every luma and chroma mode
    (CfL among them), every filter-intra mode, palettes of 2-8 colours in
    luma and in chroma, every transform size, every intra transform type,
    frames with CDEF and without, and restoration units of each type; and
    of intra block copy, use_intrabc 0 and 1, each MV joint, the MV classes
    0-7 (aom's copies reach no farther), txfm_split leaves at depths 0 and
    1 (aom splits no intra block copy twice) and every inter transform
    type; and 10- and 12-bit frames in each subsampling."""
    total = {}
    for name in sorted(LAYOUTS):
        counts = {}
        images.decode_avif(LAYOUTS[name], name, counts)
        for field, values in counts.items():
            total[field] = [a + b for a, b in zip(total.get(field, [0] * len(values)), values)]
    assert all(total["partition"]), total["partition"]
    assert all(total["y_mode"]) and all(total["uv_mode"]), (total["y_mode"], total["uv_mode"])
    assert all(total["filter_intra_mode"]), total["filter_intra_mode"]
    assert all(total["palette_y"][2:]) and all(total["palette_uv"][2:]), (total["palette_y"], total["palette_uv"])
    assert all(total["tx_size"]), total["tx_size"]
    intra_types = (0, 1, 2, 3, 9, 10, 11)  # DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX, V_DCT, H_DCT
    assert all(total["tx_type"][t] for t in intra_types), total["tx_type"]
    assert total["cdef_on"][0] and total["cdef_off"][0]
    assert all(total["lr_type"][:3]), total["lr_type"]
    assert total["lossless"][0] and total["superblock128"][0] and total["tiles"][0] > len(LAYOUTS)
    assert all(total["use_intrabc"]) and all(total["mv_joint"]), (total["use_intrabc"], total["mv_joint"])
    assert all(total["mv_class"][:8]), total["mv_class"]
    assert all(total["txfm_split"][:2]) and all(total["inter_tx_type"]), (total["txfm_split"], total["inter_tx_type"])
    assert all(total["bit_depth"][4:]), total["bit_depth"]  # [10-bit, 12-bit] x [4:2:0, 4:2:2, 4:4:4, 4:0:0]


# --- damaged files ------------------------------------------------------------------------------


def _damaged(r, n: int, names=("pil-420-full.avif", "pil-444-cdef-restoration.avif", "pil-alpha-premultiplied.avif",
                                "box-idat.avif", "pil-420-screen.avif", "pil-tiles-2x2.avif")):
    """``n`` files damaged from a few committed layouts (``names``): a
    container byte replaced, the file cut, a bit of the AV1 stream's first
    bytes (its OBU and sequence headers) or of its tile data flipped."""
    bases = [LAYOUTS[f"{fx.AVIF}/{k}"] for k in names]
    for _ in range(n):
        d = bytearray(bases[int(r.integers(0, len(bases)))])
        kind = int(r.integers(0, 4))
        at = d.find(b"mdat") + 4
        if at + 24 > len(d):  # the item lives in idat
            at = d.find(b"\x0a", d.find(b"idat"))
        if kind == 0:
            d[int(r.integers(0, at))] = int(r.integers(0, 256))
        elif kind == 1:
            d = d[:int(r.integers(8, len(d)))]
        elif kind == 2:
            d[int(r.integers(at, min(len(d), at + 24)))] ^= 1 << int(r.integers(0, 8))
        else:
            d[int(r.integers(at, len(d)))] ^= 1 << int(r.integers(0, 8))
        yield bytes(d)


@pytest.mark.parametrize("part", range(4))
def test_seeded_damaged_files_match_pillow(part):
    """200 damaged files (four parts of 50): the same pixels where Pillow
    reads one, a refusal naming the file where Pillow refuses it; a damaged
    header may meet a refusal by name (a 10-bit flag, quantizer matrices,
    a frame of another size than its item)."""
    r = np.random.default_rng(2750 + part)
    got = [_held_to_pillow(d, f"damaged {part}.{k}") for k, d in enumerate(_damaged(r, 50))]
    assert got.count("read") >= 10 and got.count("refused") >= 10


@pytest.mark.slow
def test_many_seeded_damaged_files_match_pillow():
    r = np.random.default_rng(2760)
    got = _sweep((f"damaged {k}", d) for k, d in enumerate(_damaged(r, 5000)))
    print(got)
    assert not got["failed"], got


#: the bases of the damaged files of intra block copy and of 10- and 12-bit samples
IBC_DEEP_BASES = ("ibc-420.avif", "ibc-444-no-palette.avif", "ibc-texture-q70.avif", "ibc-tiles-2x2.avif",
                  "deep-10-420-full.avif", "deep-12-422-q55.avif", "deep-10-420-mc6-alpha-premultiplied.avif",
                  "deep-12-420-cdef-restoration.avif", "deep-10-420-screen-intrabc.avif")


@pytest.mark.parametrize("part", range(4))
def test_seeded_damaged_intrabc_and_deep_files_match_pillow(part):
    """200 damaged files of intra block copy and of 10- and 12-bit samples
    (four parts of 50), held to Pillow as ``_damaged``'s are: a corrupt
    vector, a transform tree or a high-depth sample path meets Pillow's
    pixels or its refusal."""
    r = np.random.default_rng(2870 + part)
    got = [_held_to_pillow(d, f"damaged {part}.{k}") for k, d in enumerate(_damaged(r, 50, IBC_DEEP_BASES))]
    assert got.count("read") >= 10 and got.count("refused") >= 10


@pytest.mark.slow
def test_many_seeded_damaged_intrabc_and_deep_files_match_pillow():
    r = np.random.default_rng(2880)
    got = _sweep((f"damaged {k}", d) for k, d in enumerate(_damaged(r, 4000, IBC_DEEP_BASES)))
    print(got)
    assert not got["failed"], got


# --- originals under listed names through the port and the JAX package -----------------------------


def _originals(root: str) -> str:
    """Small AVIF originals under listed names: 4:2:0 at the defaults (.jpg),
    4:4:4 with CDEF and restoration (.png), screen content (.jpeg), 4:0:0
    limited range (.bmp), premultiplied alpha (.webp), a 4:2:2 file of
    128 px superblocks (.png), screen content of intra block copy (.jpg), a
    10-bit 4:2:0 file (.png) and a 12-bit 4:4:4 one of premultiplied alpha
    (.webp)."""
    os.makedirs(root)
    img = fx._avif_scene(2770, 40, 48)
    data = {
        "a.jpg": fx.pil_avif(img),
        "b.png": fx.pil_avif(img, subsampling="4:4:4", speed=3, advanced={"enable-cdef": "1",
                                                                          "enable-restoration": "1"}),
        "c.jpeg": fx.pil_avif(fx._avif_screen(2771, 40, 48), advanced={"tune-content": "screen"}),
        "d.bmp": fx.pil_avif(img, subsampling="4:0:0", range="limited"),
        "e.webp": fx.pil_avif(fx.with_alpha(img, 2772), alpha_premultiplied=True),
        "f.png": fx.pil_avif(img, subsampling="4:2:2", speed=0),
        "g.jpg": fx.pil_avif(fx._avif_text(2774, 192, 192), advanced={"tune-content": "screen"}),
        "h.png": fx.deep_avif(fx.deep_planes(2775, 40, 48, 10), 10),
        "i.webp": fx.deep_avif(fx.deep_planes(2776, 40, 48, 12, "4:4:4"), 12, "4:4:4",
                               alpha=fx.deep_planes(2777, 40, 48, 12, "4:0:0")[0], premultiplied=True),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_these_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of AVIF originals under listed names."""
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 9
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 36


def test_loader_reads_avif_as_jax_pillow_fallback(tmp_path):
    """A prepared set of AVIF files under listed names (two of them 10- and
    12-bit): the port's loader reads each as the JAX package's
    ``StageDataset`` does through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    for i in range(8):
        img = fx.smooth_scene(2773 + i, 16, 16, cell=4, step=8)
        kw = ({}, {"subsampling": "4:4:4"}, {"speed": 0, "quality": 40}, {"range": "limited"})[i % 4]
        data = fx.pil_avif(img, **kw)
        if i >= 6:  # 10-bit 4:2:0 and 12-bit 4:2:2 of limited range
            depth, ss = (10, "4:2:0") if i == 6 else (12, "4:2:2")
            data = fx.deep_avif(fx.deep_planes(2773 + i, 16, 16, depth, ss), depth, ss, full=i == 6)
        (folder / f"image-{i}.{('png', 'jpg', 'webp', 'bmp')[i % 4]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_as_avif_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on AVIF files (4:2:0, 4:4:4 with
    CDEF, premultiplied alpha, 10-bit 4:2:0, 12-bit 4:0:0 with alpha) at
    the stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2781, 32, 32)
    files = {"face.avif": fx.pil_avif(img),
             "face.jpg": fx.pil_avif(img, subsampling="4:4:4", advanced={"enable-cdef": "1"}),
             "face.png": fx.pil_avif(fx.with_alpha(img, 2782), alpha_premultiplied=True),
             "face.webp": fx.deep_avif(fx.deep_planes(2783, 32, 32, 10), 10),
             "face.bmp": fx.deep_avif(fx.deep_planes(2784, 32, 32, 12, "4:0:0"), 12, "4:0:0",
                                      alpha=fx.deep_planes(2785, 32, 32, 12, "4:0:0")[0])}
    for name, data in files.items():
        path = _write(tmp_path, name, data)
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)


def test_port_reads_avif_without_an_image_library():
    """Every port module imported and an AVIF file and a PNG decoded: no
    image library (Pillow, imageio, OpenCV, scikit-image, pillow_avif) is
    imported, and the native library links no AV1, AVIF or YUV library
    (``ldd``, ``nm -D``: no dav1d, aom, avif or libyuv symbols)."""
    path = os.path.join(fx.FIXTURES, fx.AVIF, "pil-alpha-premultiplied.avif")
    code = (
        "import importlib, pkgutil, sys\n"
        "import byogan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'byogan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from byogan_tpu_torch.data import images\n"
        f"assert images.read_image({path!r}, lane='pillow').shape == (72, 88, 3)\n"
        f"images.read_image({os.path.join(fx.FIXTURES, 'adam7-rgb8.png')!r}, lane='pillow')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'imageio', 'cv2', 'skimage', 'pillow_avif')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lib = str(native.native_build.LIBRARY)
    linked = subprocess.run(["ldd", lib], capture_output=True, text=True).stdout
    assert not re.search(r"dav1d|aom|avif|yuv|gav1|rav1e|SvtAv1", linked), linked
    symbols = subprocess.run(["nm", "-D", lib], capture_output=True, text=True).stdout
    assert not re.search(r"\b(dav1d_|aom_|avif[A-Z]|I420To|ARGBUnattenuate)", symbols)
