"""Build the native image-IO library (byogan_tpu/native/build.py).

One ``g++ -c`` a source, as many at once as the process has cores, then
one link make the port's own codecs into ``build/libbyogan_io.so`` at the
root of the checkout (git-ignored, beside the CUDA kernels of
``ops/build.py``), at first use and again whenever a source is newer:

    g++ -O3 -fPIC -std=c++17 -ffp-contract=off -c <source> -o <source>.o   (each of SOURCES)
    g++ -shared byogan_io.o png.o ... zstd.o -o build/libbyogan_io.so -lz

``-ffp-contract=off`` keeps the compiler from fusing a multiply and an add
into one rounding on machines with FMA instructions, so that lab.cpp's
float pipeline rounds as LittleCMS's does, jpeg2000.cpp's 9/7 wavelet and
ICT as OpenJPEG's, and avif_rgb.cpp's float conversions as libavif's,
wherever it is built.

zlib is the one library it links (PNG's inflate), on every machine: no
libpng, libjpeg, libwebp, liblzma, libzstd or libopenjp2 (xz.cpp and zstd.cpp
are the port's own decoders of LZMA and ZSTD TIFF, jpeg2000.cpp and
jpeg2000_t1.cpp its JPEG 2000 decoder, av1_*.cpp its AV1 decoder).  A machine without ``zlib.h``
fails the build, and the ``RuntimeError`` carries the compiler's output.
Concurrent builds, such as test workers starting together, take a file
lock and compile into a directory of their own, whose library replaces
the old one in one step.

    python -m byogan_tpu_torch.native.build [--force]
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = tuple(HERE / f for f in ("byogan_io.cpp", "png.cpp", "jpeg_decode.cpp", "jpeg_arith.cpp", "jpeg_lossless.cpp",
                                   "jpeg_encode.cpp", "jpeg_tables.cpp", "webp.cpp", "vp8_decode.cpp", "vp8l_decode.cpp",
                                   "webp_tables.cpp", "gif.cpp", "tiff.cpp", "ccitt.cpp", "lab.cpp", "pnm_tga.cpp",
                                   "psd_pcx_sgi_qoi.cpp", "bcn.cpp", "fli_msp_xbm.cpp", "im_bit.cpp", "xz.cpp",
                                   "zstd.cpp", "jpeg2000.cpp", "jpeg2000_t1.cpp", "av1_obu.cpp", "av1_symbol.cpp",
                                   "av1_cdfs.cpp", "av1_tables.cpp", "av1_modes.cpp", "av1_coefs.cpp", "av1_intra.cpp",
                                   "av1_itx.cpp", "av1_deblock.cpp", "av1_cdef.cpp", "av1_lr.cpp", "av1_intrabc.cpp",
                                   "avif_rgb.cpp"))
HEADERS = (HERE / "codec.h", HERE / "jpeg.h", HERE / "webp.h", HERE / "jpeg2000.h", HERE / "av1.h", HERE / "av1_decoder.h")
BUILD = HERE.parent.parent / "build"
LIBRARY = BUILD / "libbyogan_io.so"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off")
LIBS = ("-lz",)


def compile_command(source: Path, obj: str) -> list:
    return ["g++", *FLAGS, "-c", str(source), "-o", obj]


def command(out: str, objects: list) -> list:
    """The link of ``objects`` into ``out``."""
    return ["g++", "-shared", *map(str, objects), "-o", out, *LIBS]


def _stale() -> bool:
    return not LIBRARY.exists() or LIBRARY.stat().st_mtime < max(p.stat().st_mtime for p in SOURCES + HEADERS)


def _run_all(commands: list) -> None:
    """Runs ``commands``, as many at once as this process has cores;
    raises ``RuntimeError`` naming the first that fails, with its output."""
    def run(cmd):
        return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    with ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0))) as pool:
        for cmd, done in zip(commands, pool.map(run, commands)):
            if done.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout}")


def build(force: bool = False) -> Path:
    """The library's path, compiled first if missing, stale or ``force``.
    Raises ``RuntimeError`` with the compiler's output if it fails."""
    if not force and not _stale():
        return LIBRARY
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "libbyogan_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or _stale():  # another process may have built it meanwhile
            with tempfile.TemporaryDirectory(prefix=".libbyogan_io.", dir=BUILD) as tmp:
                objs = [os.path.join(tmp, s.with_suffix(".o").name) for s in SOURCES]
                _run_all([compile_command(s, o) for s, o in zip(SOURCES, objs)])
                out = os.path.join(tmp, LIBRARY.name)
                _run_all([command(out, objs)])
                os.replace(out, LIBRARY)
    return LIBRARY


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
