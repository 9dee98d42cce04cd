"""The port's PNM and Targa readers against Pillow and the JAX package, on the CPU.

The JAX package reads a PBM, PGM, PPM (or Pillow's PFM and CMYK variants)
or a Targa under a listed extension through Pillow alone: its prep and
``cli.project`` call ``Image.open(path).convert("RGB")``, and its loader
falls back to the same call.  So the port's ``data/images.decode_pnm`` and
``decode_tga`` (numpy, with the plain PNM and Targa RLE loops in the
native library) are held bit for bit to Pillow 12.1.0's
``convert("RGB")``: on every magic and maxval kind, plain and raw, plain
files whose comments and tokens cross Pillow's 1 MiB read blocks, Pillow's
own writers, Targa of every type and depth with colour-map starts, 16-bit
maps, orientations and RLE packets across rows, on 480 seeded files, and
on Pillow's refusals with the file and the reason named.  Then a folder of
ICO, PNM, Targa and TIFF originals under listed names through the port's
``cli.prep`` against the JAX package's ``prepare_pyramid``, the loader
against the JAX loader's Pillow fallback, and ``cli.project`` targets given
as ``.ppm`` and ``.tga`` against the JAX CLI's arrays.  Tolerance 0.
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
from test_torch_port_gif import _same_as_pillow, _write  # noqa: E402

LAYOUTS = {k: v for k, v in fx.ico_pnm_tga_layouts().items() if k.split("/")[1] in ("pnm", "tga")}
REFUSALS = {k: v for k, v in fx.ico_pnm_tga_refusals().items() if k.startswith(("pnm", "tga"))}
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
BLOCK = 1 << 20  # Pillow's SAFEBLOCK: its plain PNM decoder reads blocks of this


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1][:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".jpg", LAYOUTS[name])  # under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_file_raises_naming_the_file_and_the_reason(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name[:-4] + ".png", data)
    with pytest.raises(Exception):  # Pillow refuses it too: OSError, ValueError, UnidentifiedImageError
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


def _plain_across_blocks(case: str) -> bytes:
    """A plain PGM a little over one or two read blocks, with a token, a
    comment or Pillow's comment-end quirk where the first block ends."""
    head = b"P2\n1200 1000\n255\n"
    r = np.random.default_rng(1840)
    body = b" ".join(b"%d" % v for v in r.integers(0, 256, 1200 * 1000))
    cut = BLOCK - len(head)  # the first block's end, in body
    while body[cut - 1:cut] == b" ":
        cut += 1
    if case == "token":  # the block ends inside a token
        return head + body
    if case == "comment":  # a comment from before the block's end to after it
        return head + body[:cut - 4] + b" #across the block's end\n" + body[cut - 4:]
    if case == "comment-spans-a-block":  # a comment longer than a block
        return head + body[:cut - 4] + b" #" + b"x" * (BLOCK + 100) + b"\n " + body[cut - 4:]
    if case == "comment-end-quirk":  # the next block starts with LF and holds a CR later: the comment ends there
        at = BLOCK - len(head) - 10
        return head + body[:at] + b" #" + b"y" * 8 + b"\n12 13 \r 14 " + body[at:]
    if case == "token-split-by-comment":  # a comment inside a token at the block's end joins its two halves
        return head + body[:cut - 2] + b"#c\n" + body[cut - 2:]
    if case == "long-token-at-block-end":  # Pillow checks the half token kept for the next block
        return head + body[:cut - 1] + b"1" * 11 + b" " + body[cut + 10:]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["token", "comment", "comment-spans-a-block", "comment-end-quirk",
                                  "token-split-by-comment", "long-token-at-block-end"])
def test_plain_pnm_across_read_blocks_matches_pillow(tmp_path, case):
    _same_as_pillow(_write(tmp_path, "a.png", _plain_across_blocks(case)), case)


def test_plain_pbm_across_read_blocks_matches_pillow(tmp_path):
    """P1 tokens need no whitespace; a comment across the block's end, a
    bad byte in the first block past the samples the image needs."""
    r = np.random.default_rng(1841)
    bits = r.integers(0, 2, 1100 * 1000)
    body = b"".join(b"%d" % v for v in bits)
    head = b"P1 1100 1000\n"
    at = BLOCK - len(head) - 3
    assert _same_as_pillow(_write(tmp_path, "a.png", head + body[:at] + b"#c\r" + body[at:]), "comment")
    _same_as_pillow(_write(tmp_path, "b.png", b"P1 2 2\n0101 x"), "bad byte past the samples")


@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB"])
def test_pillow_written_pnm_matches_pillow(tmp_path, mode):
    img = fx.smooth_scene(1842, 23, 31, cell=8, step=8)
    im = Image.fromarray(img).convert(mode) if mode != "I;16" else Image.fromarray(
        img[..., 0].astype(np.uint16) * 250)
    path = str(tmp_path / "a.bmp")
    im.save(path, "PPM")
    assert _same_as_pillow(path, mode)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
def test_pillow_written_tga_matches_pillow(tmp_path, mode, rle):
    img = fx.smooth_scene(1843, 37, 29, cell=8, step=8)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).convert(mode).save(path, "TGA", rle=rle, id_section=b"an id")
    _same_as_pillow(path, f"{mode} rle={rle}")


def _token(r, v: int) -> bytes:
    """A sample as a plain token, at times with a sign, leading zeros or an
    underscore, at times not an integer."""
    k = r.random()
    if k < 0.03:
        return b"+%d" % v
    if k < 0.05:
        return b"%011d" % v if r.random() < 0.3 else b"%05d" % v
    if k < 0.06 and v >= 10:
        return b"%d_%d" % (v // 10, v % 10)
    if k < 0.065:
        return b"-%d" % (v + int(r.integers(0, 2)))
    if k < 0.067:
        return b"1.5"
    return b"%d" % v


def _seeded_pnm(r) -> bytes:
    """A PNM over the reader's parameters together: magic, size, maxval,
    header whitespace and comments, plain tokens, samples above maxval,
    truncation."""
    magic = [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0CMYK", b"PyRGBA", b"PyCMYK"][int(r.integers(0, 10))]
    w, h = int(r.integers(1, 12)), int(r.integers(1, 9))
    maxval = int(r.choice([1, 7, 100, 255, 255, 256, 1000, 4095, 65535]))
    bands = {b"P3": 3, b"P6": 3, b"P0CMYK": 4, b"PyRGBA": 4, b"PyCMYK": 4}.get(magic, 1)
    sep = [b" ", b"\n", b"\t", b"  ", b"\r\n", b" #c\n", b"#x\r"][int(r.integers(0, 7))]
    head = magic + b"\n" + sep.lstrip(b"#cx") + b"%d" % w + sep + b"%d" % h
    if magic == b"Pf":
        head += b" " + [b"-1.0", b"1.0", b"2.5e2", b"-0.5"][int(r.integers(0, 4))]
    elif magic not in (b"P1", b"P4"):
        head += sep + b"%d" % maxval
    head += [b"\n", b" ", b"\r"][int(r.integers(0, 3))]
    top = 2 if magic in (b"P1", b"P4") else maxval + 1 + (int(r.integers(0, 3)) if r.random() < 0.05 else 0)
    s = r.integers(0, top, (h, w, bands))
    if magic in (b"P1", b"P2", b"P3"):
        tokens = [_token(r, int(v)) for v in s.reshape(-1)]
        joins = [b" ", b"\n", b"  ", b"\t"] + ([b""] if magic == b"P1" else [])
        body = b"".join(t + (joins[int(r.integers(0, len(joins)))] if r.random() > 0.02 else b" #c\n")
                        for t in tokens)
    elif magic == b"P4":
        body = fx._pack(s[..., :1], 1).tobytes()
    elif magic == b"Pf":
        body = r.normal(100, 120, (h, w)).astype("<f4" if r.random() < 0.5 else ">f4").tobytes()
    else:
        body = s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    data = head + body
    return data[:int(r.integers(2, len(data)))] if r.random() < 0.1 else data


def _seeded_tga(r) -> bytes:
    """A Targa over the reader's parameters together: type, depth, colour
    map (start, entries, depth), ID field, flags, RLE packets of random
    lengths (runs that may cross rows), truncation."""
    itype = int(r.choice([1, 2, 3, 9, 10, 11]))
    depth = int(r.choice({1: [8, 8, 16], 2: [16, 24, 32, 8], 3: [8, 8, 16, 1, 24]}[itype & 7]))
    w, h = int(r.integers(1, 12)), int(r.integers(1, 9))
    cmap, start, map_depth = None, 0, 24
    if (itype & 7) == 1 or r.random() < 0.1:
        map_depth = int(r.choice([24, 24, 16, 32]))
        n = int(r.integers(0, 40))
        cmap = r.integers(0, 256, n * map_depth // 8).astype(np.uint8).tobytes()
        start = int(r.choice([0, 0, 1, 5, 250]))
    pixel = max(1, depth // 8)
    row = (w * depth + 7) // 8
    px = r.integers(0, 256 if depth != 8 or cmap is None else 48, (h, row)).astype(np.uint8)
    if itype & 8:
        if r.random() < 0.5:
            body = fx.tga_rle(px, pixel, cross_rows=r.random() < 0.5)
        else:  # packets of random kinds and lengths over the same bytes, runs crossing rows at times
            body, flat, at = bytearray(), px.reshape(-1), 0
            while at < flat.size:
                n = int(r.integers(1, 6))
                if r.random() < 0.5:
                    body += bytes([0x80 | (n - 1)]) + flat[at:at + pixel].tobytes()
                else:
                    body += bytes([n - 1]) + flat[at:at + n * pixel].tobytes().ljust(n * pixel, b"\0")
                at += n * pixel
            body = bytes(body)
    else:
        body = px.tobytes()
    flags = int(r.choice([0, 0x20, 0x10, 0x30, 0x08]))
    data = fx.tga_header(w, h, itype, depth, id_field=b"id" * int(r.integers(0, 3)), cmap=cmap, start=start,
                         map_depth=map_depth, flags=flags) + body
    return data[:int(r.integers(18, len(data)))] if r.random() < 0.1 else data


@pytest.mark.parametrize("seed", range(3))
def test_seeded_pnm_match_pillow(tmp_path, seed):
    """80 seeded PNM files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(1850 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_pnm(r)), f"file {t}")
                  for t in range(80))
    assert decoded > 30


@pytest.mark.parametrize("seed", range(3))
def test_seeded_tga_match_pillow(tmp_path, seed):
    """80 seeded Targa files a seed, as ``test_seeded_pnm_match_pillow``."""
    r = np.random.default_rng(1860 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_tga(r)), f"file {t}")
                  for t in range(80))
    assert decoded > 30


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``ico_pnm_tga/`` are what
    ``ico_pnm_tga_fixtures`` writes here, and the manifest records each:
    Pillow's RGB, or for a refusal the reason and Pillow's error; and the
    card's originals, written anew (never committed), by their hashes."""
    made = fx.ico_pnm_tga_fixtures()
    committed = fx.committed_ico_pnm_tga()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    files = fx.load_manifest()["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.ICO_PNM_TGA}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    card = fx.load_manifest()["card"]
    assert sorted(card) == sorted(fx.card_originals()) == sorted(f"{fx.ICO_PNM_TGA}/card/{n}"
                                                                 for n in fx.CARD_ORIGINALS)
    assert sum(map(len, committed.values())) < 200_000


def _originals(root: str) -> str:
    """Small originals under listed names: a P6 at maxval 1000 (.jpg), a
    plain P3 with comments (.jpeg), an RLE Targa of 16-bit pixels mirrored
    (.png), a colour-mapped Targa (.bmp), an icon with a PNG and a BMP
    frame (.webp), a cursor (.png), a 4-bit gray TIFF (.jpg) and a CMYK
    TIFF (.png)."""
    os.makedirs(root)
    img = fx.source_image(1890, 37, 45)
    r = np.random.default_rng(1891)
    idx, palette = fx._quantised(img, 5)
    words = (img[..., 0].astype(np.int64) >> 3 << 10 | img[..., 1].astype(np.int64) >> 3 << 5 | img[..., 2] >> 3)
    data = {
        "a.jpg": fx.pnm_raw(img.astype(np.int64) * 1000 // 255, b"P6", 1000),
        "b.jpeg": fx.pnm_plain(img, b"P3", 255, per_line=11, comment_every=5),
        "c.png": fx.tga_file(words.astype("<u2").view(np.uint8).reshape(37, 45, 2), 10, 16, rle_cross_rows=True,
                             flags=0x10),
        "d.bmp": fx.tga_file(idx[..., None].astype(np.uint8), 9, 8, rle_cross_rows=False,
                             cmap=palette[:, ::-1].astype(np.uint8).tobytes(), flags=0x20),
        "e.webp": fx.icon_file([(16, 16, 0, 24, fx.icon_dib(img[:16, :16, ::-1], 24)),
                                (45, 37, 0, 32, fx.png_bytes(img, 8, 2))]),
        "f.png": fx.icon_file([(45, 37, 0, 4, fx.icon_dib(img[..., ::-1], 24))], kind=2),
        "g.jpg": fx.tiff_bytes(img[..., 1] >> 4, 4, 1, compression=5, rows_per_strip=8),
        "h.png": fx.tiff_bytes(r.integers(0, 256, (37, 45, 4)), photometric=5, compression=8, predictor=2),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_ico_pnm_tga_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of ICO, CUR, PNM, Targa and TIFF originals
    under listed names."""
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 8
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 32


def test_loader_reads_ico_pnm_tga_as_jax_pillow_fallback(tmp_path):
    """A prepared set of PNM, Targa and ICO files under listed names: the
    port's loader reads each as the JAX package's ``StageDataset`` does
    through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(1892)
    for i in range(6):
        img = r.integers(0, 256, (16, 16, 3))
        data = (fx.pnm_raw(img, b"P6") if i % 3 == 0 else
                fx.tga_file(img[..., ::-1].astype(np.uint8), 10, 24, rle_cross_rows=i % 2 == 0) if i % 3 == 1 else
                fx.icon_file([(16, 16, 0, 24, fx.icon_dib(img[..., ::-1], 24))]))
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_as_ppm_and_tga_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.ppm`` and ``face.tga`` at
    the stage's size and at another: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``, resized where it is not the
    stage's size)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(1893, 32, 32)
    paths = [_write(tmp_path, "face.ppm", fx.pnm_raw(img, b"P6")),
             _write(tmp_path, "face.tga", fx.tga_file(img[..., ::-1], 10, 24, rle_cross_rows=True))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
