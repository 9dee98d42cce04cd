"""Build the native image-IO library (byogan_tpu/native/build.py).

One ``g++`` call compiles the port's own codecs into
``build/libbyogan_io.so`` at the root of the checkout (git-ignored, beside
the CUDA kernels of ``ops/build.py``), at first use and again whenever a
source is newer:

    g++ -O3 -shared -fPIC -std=c++17 byogan_io.cpp png.cpp jpeg_decode.cpp \\
        jpeg_arith.cpp jpeg_lossless.cpp jpeg_encode.cpp jpeg_tables.cpp webp.cpp \\
        vp8_decode.cpp vp8l_decode.cpp webp_tables.cpp -o build/libbyogan_io.so -lz

zlib is the one library it links (PNG's inflate), on every machine: no
libpng, libjpeg or libwebp.  A machine without ``zlib.h`` fails the build,
and the ``RuntimeError`` carries the compiler's output.  Concurrent
builds, such as test workers starting together, take a file lock and
compile to a name of their own, which replaces the library in one step.

    python -m byogan_tpu_torch.native.build [--force]
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = tuple(HERE / f for f in ("byogan_io.cpp", "png.cpp", "jpeg_decode.cpp", "jpeg_arith.cpp", "jpeg_lossless.cpp",
                                   "jpeg_encode.cpp", "jpeg_tables.cpp", "webp.cpp", "vp8_decode.cpp", "vp8l_decode.cpp",
                                   "webp_tables.cpp"))
HEADERS = (HERE / "codec.h", HERE / "jpeg.h", HERE / "webp.h")
BUILD = HERE.parent.parent / "build"
LIBRARY = BUILD / "libbyogan_io.so"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)


def command(out: str) -> list:
    return ["g++", *FLAGS, *map(str, SOURCES), "-o", out, *LIBS]


def _stale() -> bool:
    return not LIBRARY.exists() or LIBRARY.stat().st_mtime < max(p.stat().st_mtime for p in SOURCES + HEADERS)


def build(force: bool = False) -> Path:
    """The library's path, compiled first if missing, stale or ``force``.
    Raises ``RuntimeError`` with the compiler's output if it fails."""
    if not force and not _stale():
        return LIBRARY
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "libbyogan_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or _stale():  # another process may have built it meanwhile
            fd, tmp = tempfile.mkstemp(prefix=".libbyogan_io.", suffix=".so", dir=BUILD)
            os.close(fd)
            cmd = command(tmp)
            try:
                done = subprocess.run(cmd, capture_output=True, text=True)
                if done.returncode != 0:
                    raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout}{done.stderr}")
                os.replace(tmp, LIBRARY)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return LIBRARY


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
