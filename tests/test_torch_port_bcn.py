"""The port's BCn block decoder against Pillow, on the CPU.

DDS and FTEX textures reach the JAX package through Pillow's C ``bcn``
decoder, BLP2's DXT textures through Python functions of BlpImagePlugin
(its prep, ``cli.project`` and its loader's fallback call
``Image.open(path).convert("RGB")``).  So ``native/bcn.cpp``
(``native.bcn``) is held bit for bit to what Pillow 12.1.0 decodes from
the same bytes, before ``convert("RGB")`` (RGBA, L or RGB, alpha
included): seeded random blocks of BC1 (both colour modes), BC2, BC3,
BC4, BC5, BC5S, every BC6H and BC6HS mode (the reserved ones too) and
every BC7 mode (the reserved one, rotations, index selection and p-bits
among the random bits), at sizes that cut edge blocks; and BLP2's DXT1,
DXT3 and DXT5 beside DDS's BC1, BC2 and BC3 on the same block bytes,
which Pillow's two decoders expand differently (BLP's 5:6:5 fields are
not widened by their top bits).  Tolerance 0.
"""

import io
import os
import re
import sys

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402

#: a DDS of each bcn format: FourCC or DXGI format
DDS = {"BC1": {"fourcc": b"DXT1"}, "BC2": {"fourcc": b"DXT3"}, "BC3": {"fourcc": b"DXT5"}, "BC4": {"fourcc": b"ATI1"},
       "BC5": {"fourcc": b"ATI2"}, "BC5S": {"fourcc": b"BC5S"}, "BC6H": {"dxgi": fx.DXGI["BC6H_UF16"]},
       "BC6HS": {"dxgi": fx.DXGI["BC6H_SF16"]}, "BC7": {"dxgi": fx.DXGI["BC7_UNORM"]}}
SIZES = ((4, 4), (16, 12), (13, 7), (1, 9), (30, 2))


def _pillow_raw(data: bytes) -> np.ndarray:
    """Pillow's decode of a texture file, in its own mode (h, w, bands)."""
    with Image.open(io.BytesIO(data)) as im:
        a = np.asarray(im)
    return a[:, :, None] if a.ndim == 2 else a


def _blocks(r, kind: str, n: int, mode=None) -> np.ndarray:
    return fx.bcn_blocks(r, kind[:3] if kind.startswith("BC6") else kind, n, mode)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", sorted(DDS))
def test_random_blocks_match_pillow(kind, size):
    """Seeded random blocks (BC6H and BC7: each block of a random mode) at
    sizes whose edge blocks the image cuts."""
    w, h = size
    r = np.random.default_rng(sorted(DDS).index(kind) * 31 + w * 7 + h)
    n = (w + 3) // 4 * ((h + 3) // 4)
    blocks = _blocks(r, kind, n).tobytes()
    want = _pillow_raw(fx.dds_file(w, h, blocks, **DDS[kind]))
    np.testing.assert_array_equal(native.bcn(blocks, "t", kind, w, h), want)


@pytest.mark.parametrize("mode", range(15))
@pytest.mark.parametrize("kind", ["BC6H", "BC6HS"])
def test_every_bc6h_mode_matches_pillow(kind, mode):
    """All 14 modes of BC6H and BC6HS (delta endpoints, their sign
    extension, the transform, partitions, Pillow's half floats to bytes)
    and a reserved mode (black)."""
    r = np.random.default_rng(2300 + mode + 20 * (kind == "BC6HS"))
    blocks = _blocks(r, kind, 64, mode).tobytes()
    want = _pillow_raw(fx.dds_file(64, 16, blocks, **DDS[kind]))
    np.testing.assert_array_equal(native.bcn(blocks, "t", kind, 64, 16), want)


@pytest.mark.parametrize("mode", range(9))
def test_every_bc7_mode_matches_pillow(mode):
    """BC7's 8 modes (subsets, partitions and anchors, p-bits, rotation,
    index selection) and the reserved mode (a first byte of 0: opaque
    black), alpha included."""
    r = np.random.default_rng(2330 + mode)
    blocks = _blocks(r, "BC7", 64, mode).tobytes()
    want = _pillow_raw(fx.dds_file(64, 16, blocks, **DDS["BC7"]))
    got = native.bcn(blocks, "t", "BC7", 64, 16)
    np.testing.assert_array_equal(got, want)
    if mode == 8:
        assert (got == [0, 0, 0, 255]).all()


def test_bc1_three_colour_mode_and_bc5s_signed_endpoints():
    """BC1 blocks with color0 <= color1 (three colours and a transparent
    black), BC2 and BC3 reading the same colour block in four-colour mode;
    BC5S's endpoints as signed bytes plus 128 (its blue 128)."""
    r = np.random.default_rng(2340)
    colour = fx.bcn_blocks(r, "BC1", 16)
    c = colour[:, :4].copy().view("<u2")
    colour[:, :4] = np.sort(c, 1).view(np.uint8)  # color0 <= color1
    colour[0, 2:4] = colour[0, :2]  # equal endpoints
    bc1 = native.bcn(colour.tobytes(), "t", "BC1", 16, 16)
    np.testing.assert_array_equal(bc1, _pillow_raw(fx.dds_file(16, 16, colour.tobytes(), b"DXT1")))
    assert (bc1[..., 3] == 0).any()  # index 3: transparent black
    bc3 = np.concatenate([fx.bcn_blocks(r, "BC4", 16), colour], 1).tobytes()
    np.testing.assert_array_equal(native.bcn(bc3, "t", "BC3", 16, 16), _pillow_raw(fx.dds_file(16, 16, bc3, b"DXT5")))
    signed = fx.bcn_blocks(r, "BC5", 16)
    signed[:, [0, 8]] = [0x80, 0x7F]  # -128 and 127: the ends of the signed range
    got = native.bcn(signed.tobytes(), "t", "BC5S", 16, 16)
    np.testing.assert_array_equal(got, _pillow_raw(fx.dds_file(16, 16, signed.tobytes(), b"BC5S")))
    assert (got[..., 2] == 128).all()


@pytest.mark.parametrize("dxt", ["DXT1", "DXT3", "DXT5"])
def test_blp_dxt_and_dds_bcn_on_the_same_bytes(tmp_path, dxt):
    """The same block bytes as a BLP2 (Pillow's Python decoders) and as a
    DDS (its C bcn decoder): each port decode equals Pillow's, and the two
    differ as Pillow's do: where every index is 0, each pixel is color0,
    whose fields BLP shifts up (r << 3) and bcn widens (r << 3 | r >> 2)."""
    kind = {"DXT1": "BC1", "DXT3": "BC2", "DXT5": "BC3"}[dxt]
    r = np.random.default_rng(2350 + len(kind))
    blocks = fx.bcn_blocks(r, kind, 16)
    flat = blocks.copy()
    flat[:, -4:] = 0  # every colour index 0
    for data, name in ((blocks, "random"), (flat, "color0")):
        blp = fx.blp_file(2, 16, 16, data.tobytes(), encoding=2, alpha=8,
                          alpha_encoding={"DXT1": 0, "DXT3": 1, "DXT5": 7}[dxt])
        dds = fx.dds_file(16, 16, data.tobytes(), dxt.encode())
        blp_px = native.bcn(data.tobytes(), "t", f"BLP {dxt}" + (" alpha" if dxt == "DXT1" else ""), 16, 16)
        dds_px = native.bcn(data.tobytes(), "t", kind, 16, 16)
        with Image.open(io.BytesIO(blp)) as im:
            np.testing.assert_array_equal(blp_px, np.asarray(im), err_msg=f"BLP {name}")
        np.testing.assert_array_equal(dds_px, _pillow_raw(dds), err_msg=f"DDS {name}")
        for path, want in ((_write(tmp_path, "t.png", blp), blp_px), (_write(tmp_path, "t.jpg", dds), dds_px)):
            np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want[..., :3])
        assert (blp_px[..., :3] != dds_px[..., :3]).any()
        if name == "color0":
            b = blp_px[..., :3].astype(np.int64)
            widened = b | np.stack([b[..., 0] >> 5, b[..., 1] >> 6, b[..., 2] >> 5], -1)
            np.testing.assert_array_equal(dds_px[..., :3], widened)


def test_blp_dxt1_without_alpha_gives_three_bytes_a_pixel():
    """DXT1 in a BLP without alpha: three bytes a pixel (RGB), the
    transparent black of the three-colour mode black."""
    r = np.random.default_rng(2360)
    blocks = fx.bcn_blocks(r, "BC1", 4).tobytes()
    rgb = native.bcn(blocks, "t", "BLP DXT1", 8, 8)
    with Image.open(io.BytesIO(fx.blp_file(2, 8, 8, blocks, encoding=2, alpha=0, alpha_encoding=0))) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(rgb, np.asarray(im))
    np.testing.assert_array_equal(rgb, native.bcn(blocks, "t", "BLP DXT1 alpha", 8, 8)[..., :3])


def test_blocks_cut_short_raise_naming_the_file():
    with pytest.raises(OSError, match=re.escape("t.dds") + ": BC7 block decode failed: the file is truncated"):
        native.bcn(bytes(16 * 3), "t.dds", "BC7", 8, 8)


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(DDS))
def test_many_random_blocks_match_pillow(kind):
    """16384 seeded random blocks a kind (BC6H and BC7 of random modes)."""
    r = np.random.default_rng(2370 + sorted(DDS).index(kind))
    blocks = _blocks(r, kind, 16384).tobytes()
    want = _pillow_raw(fx.dds_file(512, 512, blocks, **DDS[kind]))
    np.testing.assert_array_equal(native.bcn(blocks, "t", kind, 512, 512), want)
