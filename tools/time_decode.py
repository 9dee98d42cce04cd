#!/usr/bin/env python3
"""Host ms of one checkout's image decodes on one thread, for comparing two
checkouts on one machine.

    python3 tools/time_decode.py [--checkout DIR] [--repeats 40]

Loads DIR's native image-IO library (``data/native.load_library``, which
builds it into DIR/build where it is missing or stale; DIR: the checkout
that holds this script by default) and times, median and least of
``--repeats`` calls after one, a 1024 px photo-like JPEG (4:2:0, quality
92, written by DIR's encoder, which writes libjpeg's bytes) decoded to RGB
through ``byogan_decode``, whatever the library's ABI (4 before the lane
argument, 5 after).  The photo is the one ``chip_smoke.py`` times (smooth
colour with noise of 2 LSB, seed 61).  Where the checkout holds them, it
also times the committed 1024 px originals ``chip_smoke.py`` times beside
it: the RGB LZW TIFF with predictor 2 (64-row strips) and the GIF with a
global table; and the committed AVIF card originals ``chip_smoke.py``'s
"time codecs AVIF" times, each read to RGB through DIR's own
``data/images.decode_avif`` (its container parse and the library's AV1
decoder and conversion).  The last line is a JSON summary with the machine's card,
where ``nvidia-smi`` finds one.  To compare two checkouts, run both inside
one call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SIDE = 1024
QUALITY = 92
#: the committed 1024 px originals timed beside the JPEG, by the key of the summary
ORIGINALS = {"tiff_lzw_predictor_1024": "tests/data/torch_port_codecs/gif_tiff/card/scan-1024.tif",
             "gif_1024": "tests/data/torch_port_codecs/gif_tiff/card/poster-1024.gif"}
#: the committed AVIF card originals, by the key of the summary
AVIF_ORIGINALS = {f"avif_{key}": f"tests/data/torch_port_codecs/avif/card/{name}" for key, name in (
    ("420_default_1024", "photo-1024.avif"), ("444_cdef_lr_sb128_tiles_1024", "photo-1024-444-cdef-lr-sb128-tiles.avif"),
    ("screen_palette_1024", "screen-1024-palette.avif"), ("premultiplied_512", "photo-512-premultiplied.avif"),
    ("screen_intrabc_1024", "screen-1024-intrabc.avif"), ("420_10bit_1024", "photo-1024-10bit.avif"))}


def photo(rng, h: int, w: int, noise: float = 2.0) -> np.ndarray:
    """Smooth colour with noise on top (``chip_smoke.photo``)."""
    yy, xx = np.mgrid[0:h, 0:w]
    i = int(rng.integers(0, 9))
    base = np.stack([np.sin(xx / (37 + 5 * c + i) + c) * np.cos(yy / (53 + i)) for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--repeats", type=int, default=40)
    args = parser.parse_args(argv)
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    from byogan_tpu_torch.data import native

    lib = native.load_library()
    abi = lib.byogan_abi_version()
    out = np.empty((SIDE, SIDE, 3), np.uint8)

    def repeat(call) -> list:
        times = []
        for _ in range(args.repeats + 1):
            t0 = time.perf_counter()
            call()
            times.append(1e3 * (time.perf_counter() - t0))
        return times[1:]

    def host_ms(path: str) -> list:
        h, w = ctypes.c_int(SIDE), ctypes.c_int(SIDE)
        call = [path.encode(), out.ctypes.data, ctypes.byref(h), ctypes.byref(w)]
        call += [0] if abi >= 5 else []

        def decode():
            rc = lib.byogan_decode(*call)
            if rc != 0:
                raise OSError(f"{path}: decode returned {rc}")
        return repeat(decode)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "photo.jpg")
        native.encode_jpeg(path, photo(np.random.default_rng(61), SIDE, SIDE), QUALITY)
        timed = {"jpeg_decode_1024": host_ms(path)}
    for key, name in ORIGINALS.items():
        if os.path.exists(os.path.join(checkout, name)):
            timed[key] = host_ms(os.path.join(checkout, name))
    for key, name in AVIF_ORIGINALS.items():
        if os.path.exists(os.path.join(checkout, name)):
            from byogan_tpu_torch.data import images

            with open(os.path.join(checkout, name), "rb") as f:
                data = f.read()
            timed[key] = repeat(lambda: images.decode_avif(data, name))
    result = {"checkout": checkout, "abi": abi}
    for key, times in timed.items():
        result[f"{key}_ms_median"] = float(np.median(times))
        result[f"{key}_ms_min"] = float(np.min(times))
    result.update(repeats=args.repeats, card=card())
    print(f"time decode: {checkout} (ABI {abi}): host ms over {args.repeats} calls on one thread, "
          + "; ".join(f"{key} median {result[f'{key}_ms_median']:.3f}, least {result[f'{key}_ms_min']:.3f}"
                      for key in timed) + f"; card {result['card']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
