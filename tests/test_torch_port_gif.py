"""The port's GIF decoder against Pillow, and GIF and TIFF originals through
prep, the loader and ``cli.project``, on the CPU.

The JAX package reads a GIF under a listed extension through Pillow alone:
its prep and ``cli.project`` call ``Image.open(path).convert("RGB")``, and
its loader falls back to the same call.  So the port's ``native/gif.cpp``
(through ``data/images.read_image``, both lanes) is held bit for bit to
Pillow 12.1.0's first frame on a file of each layout
(``torch_port_codec_fixtures.gif_layouts``: global and local tables, gray
ramps, short tables, no table, transparency and frames at an offset or past
the screen, interlaced rows, minimum code sizes 0-12, Clears mid-stream, a
table full with no Clear, no first Clear, no end code, extensions, a second
frame), on GIFs Pillow writes, on LZW data past Pillow's 65536-byte read
blocks and on 400 seeded files; and to Pillow's refusal of every other,
with the file and the reason named.  Then the GIF and TIFF originals
against the JAX package's prep, loader fallback and ``cli.project``.
Tolerance 0.
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

LAYOUTS = fx.gif_layouts()
REFUSALS = fx.gif_refusals()


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / os.path.basename(name))
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pillow(path: str):
    """Pillow's convert("RGB") of the file, or the exception it raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - OSError, ValueError, EOFError and Pillow's own
        return e


def _same_as_pillow(path: str, what: str) -> bool:
    """The port's decode of ``path`` in both lanes equals Pillow's; where
    Pillow refuses it, the port raises ``OSError`` naming the file.  True
    where Pillow decodes it."""
    want = _pillow(path)
    if isinstance(want, Exception):
        with pytest.raises(OSError, match=re.escape(path)):
            images.read_image(path)
        return False
    for lane in ("native", "pillow"):
        got = images.read_image(path, lane=lane)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want, err_msg=f"{what} ({lane} lane)")
    return True


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, name.replace(".gif", ".png"), LAYOUTS[name])  # a GIF under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_gif_raises_naming_the_file_and_the_reason(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.replace(".gif", ".jpg"), data)
    assert isinstance(_pillow(path), Exception)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("kind", ["P", "P-transparency", "L", "RGB-adaptive", "animated", "not-interlaced"])
def test_pillow_written_gif_matches_pillow(tmp_path, kind):
    r = np.random.default_rng(len(kind))
    img = fx.smooth_scene(1720 + len(kind), 48, 40, cell=16, step=24)
    im = Image.fromarray(img)
    path = str(tmp_path / "a.jpg")
    if kind == "L":
        im.convert("L").save(path, format="GIF")
    elif kind == "RGB-adaptive":
        im.convert("P", palette=Image.Palette.ADAPTIVE, colors=37).save(path, format="GIF")
    elif kind == "animated":
        frames = [Image.fromarray(np.roll(img, 7 * k, axis=1)).quantize(64) for k in range(3)]
        frames[0].save(path, format="GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)
    elif kind == "not-interlaced":
        im.quantize(200).save(path, format="GIF", interlace=False)
    else:
        q = im.quantize(int(r.integers(16, 256)))
        q.save(path, format="GIF", **({"transparency": 5} if kind == "P-transparency" else {}))
    assert _same_as_pillow(path, kind)


@pytest.mark.parametrize("stream", ["early-end", "end-code-in-first-read", "end-code-in-last-read",
                                    "table-full-no-clear", "interlaced"])
def test_data_past_pillows_read_blocks(tmp_path, stream):
    """LZW data longer than Pillow's 65536-byte reads.  An end code before
    the frame is whole returns to Pillow's loop, which feeds the decoder
    the next read and it goes on with the codes after the end code: they
    finish the frame where they are the stream's own, break it where they
    start another stream, and where no read is left the file is
    truncated.  Then a table full with no Clear, and interlaced rows."""
    r = np.random.default_rng(1730)
    pal = r.integers(0, 256, (256, 3))
    idx = r.integers(0, 256, (300, 400))
    codes = fx.gif_lzw_codes(idx.reshape(-1), 8)
    if stream == "early-end":
        head = fx.gif_pack(fx.gif_lzw_codes(idx.reshape(-1)[:60000], 8))
        tail = fx.gif_pack(fx.gif_lzw_codes(idx.reshape(-1)[60000:], 8))
        data = fx.gif_file(400, 300, [fx.gif_image(idx, data=fx.gif_sub_blocks(head + tail))], pal)
    elif stream.startswith("end-code"):  # the end code at the width of the code it precedes
        at = 30000 if stream == "end-code-in-first-read" else len(codes) - 50
        codes = codes[:at] + [(257, codes[at][1])] + codes[at:]
        data = fx.gif_file(400, 300, [fx.gif_image(idx, data=fx.gif_sub_blocks(fx.gif_pack(codes)))], pal)
    else:
        data = fx.gif_file(400, 300, [fx.gif_image(idx, interlace=stream == "interlaced", clear_when_full=False)], pal)
    assert len(data) > 2 * 65536
    path = _write(tmp_path, "big.png", data)
    assert _same_as_pillow(path, stream) is (stream not in ("early-end", "end-code-in-last-read"))


def _seeded_gif(r) -> bytes:
    """A GIF over the layouts' parameters together: screen and frame sizes
    (0 among them), offsets, code sizes 0-12, global and local tables of
    1-256 entries or gray ramps, transparency, extensions, interlace,
    Clears, missing end codes, a second frame, truncation and bytes
    overwritten."""
    def table(n):
        return [[i, i, i] for i in range(n)] if r.random() < 0.2 else r.integers(0, 256, (n, 3)).tolist()

    fw, fh = int(r.integers(0, 20)), int(r.integers(0, 20))
    min_size = int(r.choice([1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 0, 9, 12]))
    top = min(1 << min_size, 256)
    idx = r.integers(0, top, (fh, fw)) // int(r.integers(1, 6))
    blocks = []
    if r.random() < 0.3:
        blocks.append(fx.gif_extension(254, b"comment" * int(r.integers(0, 40))))
    if r.random() < 0.3:
        blocks.append(fx.gif_extension(255, b"NETSCAPE2.0", 11)[:-1] + b"\x03\x01\x00\x00\x00")
    if r.random() < 0.4:
        blocks.append(fx.gif_gce(int(r.integers(0, 256)) if r.random() < 0.6 else None, int(r.integers(0, 4))))
    if r.random() < 0.05:
        blocks.append(bytes([int(r.integers(0, 256))]))
    x, y = (int(r.integers(0, 6)) if r.random() < 0.4 else 0 for _ in range(2))
    blocks.append(fx.gif_image(idx, x, y, palette=table(int(r.integers(1, 257))) if r.random() < 0.3 else None,
                               interlace=r.random() < 0.3, min_size=min_size, clear_first=r.random() < 0.8,
                               end=r.random() < 0.8, clear_every=int(r.integers(1, 200)) if r.random() < 0.2 else None,
                               clear_when_full=r.random() < 0.5))
    if r.random() < 0.3:
        blocks.append(fx.gif_gce(1) + fx.gif_image(r.integers(0, 4, (3, 3)), min_size=2))
    data = fx.gif_file(int(r.integers(0, 24)), int(r.integers(0, 24)), blocks,
                       table(int(r.integers(1, 257))) if r.random() < 0.7 else None, trailer=r.random() < 0.9)
    if r.random() < 0.15:
        data = data[:int(r.integers(0, len(data)))]
    if r.random() < 0.1 and len(data) > 13:
        data = bytearray(data)
        for _ in range(int(r.integers(1, 4))):
            data[int(r.integers(13, len(data)))] = int(r.integers(0, 256))
        data = bytes(data)
    return data


@pytest.mark.parametrize("seed", range(4))
def test_seeded_gifs_match_pillow(tmp_path, seed):
    """100 seeded files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(1740 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}.jpg", _seeded_gif(r)), f"file {t}") for t in range(100))
    assert decoded > 40


def test_committed_gif_tiff_fixtures_are_what_the_writers_make():
    """The committed files under ``gif_tiff/`` are what
    ``gif_tiff_fixtures`` writes here, and the manifest records each:
    Pillow's RGB, or for a refusal the reason and what Pillow makes of it;
    the JAX package's prep of the card's originals."""
    made = fx.gif_tiff_fixtures()
    committed = fx.committed_gif_tiff()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.GIF_TIFF}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    listed = len(fx.GIF_TIFF_CARD) + sum(v is not None for v in fx.CARD_ORIGINALS.values())
    assert sorted(n for d in manifest["gif_tiff_prep"].values() for n in d) == sorted(
        f"image-{i}.png" for i in range(listed) for _ in range(8))
    assert sum(map(len, committed.values())) < 600_000


# --- GIF and TIFF originals through the port's entry points --------------------


def _originals(root: str) -> str:
    """Small GIF and TIFF originals under listed names: a GIF with a global
    table (.jpg), one interlaced with a local table and transparency at an
    offset (.png), a TIFF of LZW strips with predictor 2 (.jpeg) and one of
    Deflate tiles (.bmp)."""
    os.makedirs(root)
    img = fx.source_image(1750, 37, 45)
    idx, palette = fx._quantised(img, 6)
    data = {
        "a.jpg": fx.gif_file(45, 37, [fx.gif_image(idx)], palette),
        "b.png": fx.gif_file(45, 37, [fx.gif_gce(transparency=3), fx.gif_image(idx[:30, :40], 3, 5, palette=palette,
                                                                                  interlace=True)], palette[::-1]),
        "c.jpeg": fx.tiff_bytes(img, compression=5, predictor=2, rows_per_strip=8),
        "d.bmp": fx.tiff_bytes(img, compression=8, tile=(16, 16)),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_gif_and_tiff_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of GIF and TIFF originals under listed
    names; then on the card's committed 1024 px originals (two GIFs under
    .jpg names, one interlaced under .png, an LZW TIFF with predictor 2)
    with the written ones it prepares in the same process (a P6 under
    .jpg, an RLE Targa and a 4-bit gray TIFF under .png, an icon under
    .bmp: ``fx.card_originals``) against the JAX package's recorded
    pyramid."""
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
    card = tmp_path / "card"
    card.mkdir()
    committed = fx.committed_gif_tiff()
    for name, listed in fx.GIF_TIFF_CARD.items():
        (card / listed).write_bytes(committed[f"{fx.GIF_TIFF}/card/{name}"])
    written = 0
    for name, data in fx.card_originals().items():
        listed = fx.CARD_ORIGINALS[os.path.basename(name)]
        if listed:
            (card / listed).write_bytes(data)
            written += 1
    port_prep_cli.main([str(card), "4", "512", "-y", "-d", "cpu"])
    assert fx.check_prep(str(card), read_png, "gif_tiff_prep") == 8 * (len(fx.GIF_TIFF_CARD) + written)


def test_loader_reads_gif_and_tiff_as_jax_pillow_fallback(tmp_path):
    """A prepared set of GIFs and TIFFs under listed names: the port's
    loader reads each as the JAX package's ``StageDataset`` does through
    its Pillow fallback (its native lane refuses both), on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(1760)
    for i in range(6):
        img = r.integers(0, 256, (16, 16, 3))
        idx, palette = fx._quantised(img.astype(np.uint8), 4)
        data = (fx.gif_file(16, 16, [fx.gif_image(idx, interlace=i % 2 == 1)], palette) if i % 3 else
                fx.tiff_bytes(img, compression=(5, 32773)[i // 3], predictor=2 - i // 3))
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_load_target_reads_a_gif_as_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on a GIF under a .png name and a
    TIFF under a .jpg name at the stage's size: the pixels the JAX CLI
    loads (Pillow's convert("RGB"))."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(1770, 32, 32)
    idx, palette = fx._quantised(img, 5)
    paths = [_write(tmp_path, "target.png", fx.gif_file(32, 32, [fx.gif_gce(transparency=7),
                                                              fx.gif_image(idx, interlace=True)], palette)),
             _write(tmp_path, "target.jpg", fx.tiff_bytes(img, compression=5, predictor=2))]
    for path in paths:
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
