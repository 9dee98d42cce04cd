"""The port's JPEG 2000 decoder and the Pillow lane's PNG chunks before the
image data, against Pillow and the JAX package, on the CPU.

The JAX package reads an original under a listed extension through
``Image.open(path).convert("RGB")``: JPEG 2000 through Pillow 12.1.0's
plugin over OpenJPEG 2.5.4, which the card's machine lacks, so the port
carries its own decoder (``native/jpeg2000.cpp``, ``jpeg2000_t1.cpp``) and
Pillow's ``_open`` and unpackers (``data/images.py``'s
``decode_jpeg2000``).  So every committed layout of ``fx.j2k_layouts``
(Pillow's encoder, libopenjp2's through ctypes, rewritten markers, JP2
boxes, ICNS elements) and each seeded or damaged stream is held bit for
bit to Pillow's ``convert("RGB")`` in both of the port's lanes, and each
refusal (``fx.j2k_refusals``) to its reason with the file named.  The
Pillow lane's PNG chunk handlers before the image data
(``native/png.cpp``'s ``pillow_chunk``) are held to Pillow on each chunk
kind and colour type, and the native lane to the JAX package's libpng
lane.  Then originals under listed names through the port's
``cli.prep`` against the JAX package's ``prepare_pyramid``, its loader
against the JAX loader's Pillow fallback and ``cli.project`` targets
against the JAX CLI's.  Tolerance 0.
"""

import io
import os
import re
import struct
import subprocess
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.j2k_layouts()
REFUSALS = fx.j2k_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
#: the refusals Pillow reads: Part 2 markers, which the port leaves out by name
PILLOW_READS = ("part2-mct-marker.j2k",)


@pytest.fixture(scope="session")
def jax_lane(tmp_path_factory):
    """JAX's libpng/libjpeg lane, built once for all of the session's workers."""
    return fx.jax_lane(str(tmp_path_factory.getbasetemp().parent / "jax_native_lane"))


def _rgb(data: bytes):
    """Pillow's convert("RGB") of a file's bytes, or the exception it raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - OSError, ValueError, SyntaxError and Pillow's own
        return e


#: the port's refusals by name of what Pillow may read (ROADMAP §3 fault 7):
#: HTJ2K code-blocks, Part 2 markers
BY_NAME = "HTJ2K|Part 2 markers"


def _held_to_pillow(data: bytes, name: str, by_name: bool = False) -> bool:
    """The port's decode of ``data`` (``read_bytes``) equals Pillow's, or
    both refuse it (the port naming ``name``); with ``by_name``, the port
    may refuse by name (``BY_NAME``) what Pillow reads.  True where both
    read it."""
    want = _rgb(data)
    if isinstance(want, Exception):
        with pytest.raises(OSError, match=re.escape(name)):
            images.read_bytes(data, name)
        return False
    try:
        got = images.read_bytes(data, name)
    except OSError as e:
        if by_name and re.search(BY_NAME, str(e)):
            return False
        raise
    np.testing.assert_array_equal(got, want, err_msg=name)
    return True


# --- the committed files ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_the_verdict(tmp_path, name):
    """Each refusal names the file and Pillow's verdict (its own error, or
    "broken data stream" where OpenJPEG refuses the stream or Pillow's
    decoder has no unpacker); Pillow refuses each too but the Part 2
    markers, which it reads."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".jpg", data)
    reads = not isinstance(_pillow(path), Exception)
    assert reads == (name in PILLOW_READS), name
    for lane in ("native", "pillow"):
        with pytest.raises(OSError, match=f"{re.escape(path)}.*({reason})"):
            images.read_image(path, lane=lane)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``jpeg2000/`` are what ``j2k_fixtures``
    writes here (Pillow's encoder and libopenjp2 through ctypes), and the
    manifest records each (Pillow's RGB, or the reason beside Pillow's
    verdict); the card's listed originals are in the JAX package's prep
    of every slice's originals of the Pillow lane (``PILLOW_LANE_PREP``)."""
    made = fx.j2k_fixtures()
    committed = fx.committed_j2k()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.J2K}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    listed = sorted(v for v in fx.J2K_CARD.values() if v)
    part = fx.pillow_lane_images(listed)
    assert len(part) == len(listed) and len(manifest[fx.PILLOW_LANE_PREP]) == 8
    assert all(set(part) <= set(d) for d in manifest[fx.PILLOW_LANE_PREP].values())
    assert sum(len(v) for v in committed.values()) < 1_500_000


def test_committed_fixtures_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on this folder: each file decodes
    to the manifest's RGB in both lanes, each refusal raises its reason."""
    files = fx.load_manifest()["files"]
    n = 0
    for name, want in sorted(files.items()):
        if not name.startswith(f"{fx.J2K}/") or name.startswith(f"{fx.J2K}/card/"):
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
    assert sorted(fx.check_j2k_card(images.read_image)) == sorted(fx.J2K_CARD)


# --- streams written here ----------------------------------------------------------------


@pytest.mark.parametrize("ihdr_nc", [1, 2, 3, 4])
def test_modes_components_and_colour_spaces_match_pillow(ihdr_nc):
    """Pillow's mode (the JP2 header's ``ihdr`` components, a CMYK
    ``colr``) against the codestream's 1-4 components in each enumerated
    colour space OpenJPEG names (and none): Pillow's unpacker where it has
    one, its "broken data stream" where it has none."""
    r = np.random.default_rng(2650 + ihdr_nc)
    read = 0
    for nc in (1, 2, 3, 4):
        stream = fx.opj_stream(fx._j2k_planes(r, 5, 6, nc), numres=2, mct=0)
        for enumcs in (17, 16, 18, 12, 24, 0):
            read += _held_to_pillow(fx.jp2_file(stream, nc=ihdr_nc, boxes=fx.colr(enumcs)), f"{nc}-{enumcs}")
    assert read >= 2


@pytest.mark.parametrize("style", [1, 2, 4, 8, 16, 32, 9, 36, 63])
def test_code_block_styles_in_each_order_match_pillow(style):
    """Each code-block style flag, alone and together, in each progression
    order, over tiles, layers and precincts, 5/3 and 9/7."""
    r = np.random.default_rng(2660 + style)
    for k, order in enumerate(fx.J2K_PROGRESSIONS):
        planes = fx._j2k_planes(r, 19 + k, 23, 3)
        stream = fx.opj_stream(planes, mode=style, progression=order, irreversible=bool(k % 2),
                               layers=[12, 4, 2], tiles=(16, 16) if k > 2 else None,
                               precincts=[(16, 16), (8, 8)] if k != 1 else None, cblk=(8, 16))
        assert _held_to_pillow(stream, f"{style}-{order}")


@pytest.mark.parametrize("prec", [1, 3, 7, 8, 11, 13, 15, 16])
def test_precisions_and_subsampling_match_pillow(prec):
    """Samples of 1 to 16 bits, unsigned and signed, gray (L or I;16) and
    three components, some subsampled (an unspecified colour space Pillow
    takes for YCbCr) at odd offsets."""
    r = np.random.default_rng(2670 + prec)
    for sgnd in (False, True):
        assert _held_to_pillow(fx.opj_stream(fx._j2k_planes(r, 11, 14, 1, prec, sgnd), prec=prec, sgnd=sgnd,
                                             numres=2), f"gray {prec} {sgnd}")
        sub = [(1, 1), (2, 1 + prec % 2), (2, 1 + prec % 2)]
        planes = [fx._j2k_planes(r, -(-15 // dy), -(-17 // dx), 1, prec, sgnd)[0] for dx, dy in sub]
        assert _held_to_pillow(fx.opj_stream(planes, prec=prec, sgnd=sgnd, sub=sub, mct=0, numres=2,
                                             offset=(prec % 3, 1), irreversible=sgnd), f"rgb {prec} {sgnd}")


def _damaged(r, sources, n):
    """n seeded damaged copies of ``sources``: cut short, or one to five
    edits (a byte overwritten, a bit flipped, bytes taken out or put in, a
    marker's code written over two bytes)."""
    out = []
    for k in range(n):
        d = bytearray(sources[k % len(sources)])
        if r.integers(0, 4) == 0:
            out.append(bytes(d[:r.integers(10, len(d))]))
            continue
        for _ in range(r.integers(1, 6)):
            op, at = r.integers(0, 5), int(r.integers(0, len(d)))
            if op == 0:
                d[at] = r.integers(0, 256)
            elif op == 1:
                d[at] ^= 1 << r.integers(0, 8)
            elif op == 2:
                del d[at:at + r.integers(1, 8)]
            elif op == 3:
                d[at:at] = bytes(r.integers(0, 256, r.integers(1, 8)).astype(np.uint8))
            else:
                d[at:at + 2] = bytes([0xFF, r.integers(0x40, 0x100)])
        out.append(bytes(d))
    return out


def _damage_sources(r):
    planes = fx._j2k_planes(r, 24, 29, 3)
    return [fx.pil_j2k(np.stack(planes, -1).astype(np.uint8)),
            fx.opj_stream(planes, mode=63, layers=[10, 3], irreversible=True),
            fx.opj_stream(planes, mode=1, csty=6, progression="RPCL", precincts=[(16, 16), (8, 8)]),
            fx.opj_stream(planes[:1], tiles=(12, 12), tile_parts="R"),
            fx.opj_stream(planes[:1] + [p[::2, ::2] for p in planes[1:]], sub=[(1, 1), (2, 2), (2, 2)], mct=0,
                          numres=2)]


@pytest.mark.parametrize("sources", ["written", "layouts"])
def test_seeded_damaged_streams_match_pillow(sources):
    """Damaged streams read as Pillow reads them: the same pixels where
    OpenJPEG decodes what it finds, a refusal where it refuses (streams
    written here, and the committed layouts); an edit that writes an HT
    style or a Part 2 marker's code may meet the port's refusal by name."""
    r = np.random.default_rng(2680 if sources == "written" else 2682)
    base = _damage_sources(r) if sources == "written" else [LAYOUTS[n] for n in sorted(LAYOUTS)]
    read = sum(_held_to_pillow(d, f"damaged {k}", True) for k, d in enumerate(_damaged(r, base, 100)))
    assert 5 < read < 100


@pytest.mark.slow
def test_many_seeded_damaged_streams_match_pillow():
    r = np.random.default_rng(2681)
    sources = _damage_sources(r) + [LAYOUTS[n] for n in sorted(LAYOUTS)]
    for k, d in enumerate(_damaged(r, sources, 6000)):
        _held_to_pillow(d, f"damaged {k}", True)


# --- the Pillow lane's PNG chunks before the image data ---------------------------------

_FCTL = struct.pack(">IIIIIHHBB", 0, 5, 4, 0, 0, 1, 1, 0, 0)
_TOO_LARGE = zlib.compress(b"a" * ((1 << 20) + 10))
#: chunks before IDAT, each as a case of PngStream's handlers (and of the
#: walk's name test): a short or wrong body, and a right one beside it
PNG_CASES = {
    "trns-short": [(b"tRNS", b"\0")], "trns-five": [(b"tRNS", bytes(5))], "trns-six": [(b"tRNS", bytes(6))],
    "gama-short": [(b"gAMA", b"\0\0\1")], "gama": [(b"gAMA", b"\0\1\0\0")],
    "chrm-odd": [(b"cHRM", bytes(31))], "chrm": [(b"cHRM", bytes(32))],
    "srgb-empty": [(b"sRGB", b"")], "srgb": [(b"sRGB", b"\0")],
    "phys-short": [(b"pHYs", bytes(8))], "phys": [(b"pHYs", bytes(9))],
    "actl-short": [(b"acTL", bytes(7))], "actl-no-frames": [(b"acTL", bytes(8))],
    "fctl-short": [(b"fcTL", bytes(25))], "fctl": [(b"acTL", b"\0\0\0\1\0\0\0\0"), (b"fcTL", _FCTL)],
    "fctl-sequence": [(b"fcTL", struct.pack(">I", 3) + _FCTL[4:])],
    "fctl-outside": [(b"fcTL", _FCTL[:4] + struct.pack(">I", 6) + _FCTL[8:])],
    "ztxt-method": [(b"zTXt", b"k\0\1" + zlib.compress(b"x"))], "ztxt-too-large": [(b"zTXt", b"k\0\0" + _TOO_LARGE)],
    "itxt-too-large": [(b"iTXt", b"k\0\1\0\0\0" + _TOO_LARGE)], "iccp-too-large": [(b"iCCP", b"p\0\0" + _TOO_LARGE)],
    "iccp-method": [(b"iCCP", b"p\0\1" + zlib.compress(b"x"))], "text": [(b"tEXt", b"k\0v")],
    "critical-unknown": [(b"ABCD", b"x")], "name-not-word": [(b"a-cd", b"x")],
}
#: IHDR rewritten: Pillow reads the first 13 bytes of a longer one and
#: never its compression method
IHDR_CASES = {"ihdr-longer": (14, 0), "ihdr-compression-1": (13, 1)}


def _png(color: int, depth: int, chunks, ihdr_len: int = 13, compression: int = 0) -> bytes:
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rowb = (5 * depth * ch + 7) // 8
    raw = b"".join(b"\0" + bytes((i * 37 + y * 11) % 256 for i in range(rowb)) for y in range(4))
    ihdr = struct.pack(">IIBBBBB", 5, 4, depth, color, compression, 0, 0) + bytes(ihdr_len - 13)
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))  # noqa: E731
    plte = chunk(b"PLTE", bytes(range(48))) if color == 3 else b""
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + plte + b"".join(chunk(t, b) for t, b in chunks)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", sorted(PNG_CASES) + sorted(IHDR_CASES))
def test_png_chunk_before_the_image_data_matches_each_lane(tmp_path, jax_lane, case):
    """Each chunk kind before IDAT in each colour type: the Pillow lane
    refuses where Pillow's ``_open`` raises (naming the file) and reads
    its pixels where it reads; the native lane reads as the JAX package's
    libpng lane, which refuses an unknown critical chunk, a name of other
    than letters, a longer IHDR and another compression method."""
    for color, depth in ((0, 8), (0, 16), (2, 8), (3, 8), (4, 8), (6, 8)):
        if case in IHDR_CASES:
            data = _png(color, depth, [], *IHDR_CASES[case])
        else:
            data = _png(color, depth, PNG_CASES[case])
        path = _write(tmp_path, f"{case}-{color}-{depth}.png", data)
        want = _pillow(path)
        if isinstance(want, Exception):
            with pytest.raises(OSError, match=f"{re.escape(path)}: .*(chunk handler refuses)"):
                images.read_image(path, lane="pillow")
        else:
            np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
        try:
            native_want = fx.jax_decode(jax_lane, path)
        except OSError:
            with pytest.raises(OSError, match=re.escape(path)):
                images.read_image(path)
            assert case in ("critical-unknown", "name-not-word", "ihdr-longer", "ihdr-compression-1"), path
            continue
        np.testing.assert_array_equal(images.read_image(path), native_want, err_msg=path)


def test_png_chunks_before_the_image_data_differ_from_pillow_nowhere():
    """ROADMAP's count: every case of each colour type, and how many the
    Pillow lane reads otherwise than Pillow (none)."""
    differ = checked = 0
    for case in sorted(PNG_CASES) + sorted(IHDR_CASES):
        for color, depth in ((0, 8), (0, 16), (2, 8), (3, 8), (4, 8), (6, 8)):
            data = (_png(color, depth, [], *IHDR_CASES[case]) if case in IHDR_CASES
                    else _png(color, depth, PNG_CASES[case]))
            want = _rgb(data)
            try:
                got = images.read_bytes(data, case, "pillow")
            except OSError:
                got = None
            checked += 1
            differ += (got is None) != isinstance(want, Exception) or (
                got is not None and not np.array_equal(got, want))
    assert (checked, differ) == (162, 0)


# --- prep, the loader and cli.project ----------------------------------------------


def _originals(root: str) -> str:
    """Small originals under listed names: a JP2 of 9/7 layers (.jpg), a
    bare 5/3 codestream (.png), a JP2 palette image (.jpeg), a 12-bit gray
    codestream (.bmp), a JP2 of subsampled sYCC (.webp) and an ICNS whose
    element is a JP2 (.png)."""
    os.makedirs(root)
    img = fx.source_image(2690, 40, 48)
    r = np.random.default_rng(2691)
    planes = [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]]
    data = {
        "a.jpg": fx.pil_j2k(img, irreversible=True, quality_mode="rates", quality_layers=[30, 10]),
        "b.png": fx.pil_j2k(img, no_jp2=True),
        "c.jpeg": fx.jp2_file(fx.opj_stream([r.integers(0, 5, (40, 48))], numres=2),
                              boxes=fx.colr(16) + fx.pclr([(200, 10, 10), (10, 200, 10), (9, 9, 200), (0, 0, 0),
                                                           (250, 250, 250)])),
        "d.bmp": fx.opj_stream([img[..., 1].astype(np.int64) * 13], prec=12, numres=3),
        "e.webp": fx.jp2_file(fx.opj_stream(planes, sub=[(1, 1), (2, 2), (2, 2)], mct=0, numres=3),
                              boxes=fx.colr(18)),
        "f.png": fx.icns_file([(b"icp5", fx.pil_j2k(fx.smooth_scene(2692, 32, 32, cell=8), num_resolutions=3))]),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_these_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of JPEG 2000 originals under listed
    names."""
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


def test_loader_reads_these_formats_as_jax_pillow_fallback(tmp_path):
    """A prepared set of JPEG 2000 files under listed names: the port's
    loader reads each as the JAX package's ``StageDataset`` does through
    its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    for i in range(8):
        img = fx.smooth_scene(2693 + i, 16, 16, cell=4, step=8)
        data = (fx.pil_j2k(img, num_resolutions=3) if i % 4 == 0
                else fx.pil_j2k(img, irreversible=True, num_resolutions=2, no_jp2=True) if i % 4 == 1
                else fx.opj_stream([img[..., c] for c in range(3)], mode=63, numres=2) if i % 4 == 2
                else fx.icns_file([(b"icp4", fx.pil_j2k(img, num_resolutions=2))]))
        (folder / f"image-{i}.{('png', 'jpg', 'webp', 'bmp')[i % 4]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_in_these_formats_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on a JP2, a bare codestream, a JP2
    of CMYK and an ICNS with a JPEG 2000 element, at the stage's size: the
    arrays the JAX CLI builds (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2695, 32, 32)
    r = np.random.default_rng(2696)
    files = {"face.jp2": fx.pil_j2k(img, irreversible=True),
             "face.j2k": fx.pil_j2k(img, no_jp2=True, progression="CPRL"),
             "cmyk.jp2": fx.jp2_file(fx.opj_stream(fx._j2k_planes(r, 32, 32, 4), mct=0), boxes=fx.colr(12)),
             "face.icns": fx.icns_file([(b"icp5", fx.pil_j2k(img, num_resolutions=3))])}
    for name, data in files.items():
        path = _write(tmp_path, name, data)
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)


def test_port_reads_jpeg2000_without_an_image_library():
    """Every port module imported and a JPEG 2000 file, an ICNS of one and
    a PNG decoded: no image library (Pillow, imageio, OpenCV, scikit-image,
    glymur) is imported."""
    path = os.path.join(fx.FIXTURES, fx.J2K, "pil-rgb-97.jp2")
    icns = os.path.join(fx.FIXTURES, fx.J2K, "icns-icp5-jp2-rgb.icns")
    code = (
        "import importlib, pkgutil, sys\n"
        "import byogan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'byogan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from byogan_tpu_torch.data import images\n"
        f"assert images.read_image({path!r}, lane='pillow').shape == (30, 41, 3)\n"
        f"assert images.read_image({icns!r}).shape == (32, 32, 3)\n"
        f"images.read_image({os.path.join(fx.FIXTURES, 'adam7-rgb8.png')!r}, lane='pillow')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'imageio', 'cv2', 'skimage', 'glymur')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
