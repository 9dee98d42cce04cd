"""Build the native image-IO library (byogan_tpu/native/build.py).

One ``g++`` call compiles ``byogan_io.cpp`` into ``build/libbyogan_io.so``
at the root of the checkout (git-ignored, beside the CUDA kernels of
``ops/build.py``), at first use and again whenever the source is newer:

    g++ -O3 -shared -fPIC -std=c++17 byogan_io.cpp -o build/libbyogan_io.so \\
        [-lpng -lz] [-ljpeg]

libpng (with zlib) and libjpeg are linked where their headers are found;
without them the library holds the part that needs no library (the PNG
row unfilter).  Concurrent builds, such as test
workers starting together, take a file lock and compile to a name of their
own, which replaces the library in one step.

    python -m byogan_tpu_torch.native.build [--force]
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

SOURCE = Path(__file__).resolve().parent / "byogan_io.cpp"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
LIBRARY = BUILD / "libbyogan_io.so"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: header -> the libraries it needs, in link order
OPTIONAL_LIBRARIES = (("png.h", ("-lpng", "-lz")), ("jpeglib.h", ("-ljpeg",)))


def has_header(name: str) -> bool:
    """Whether the compiler finds ``<name>``."""
    probe = subprocess.run(
        ["g++", "-x", "c++", "-E", "-o", os.devnull, "-"],
        input=f"#include <{name}>\n", capture_output=True, text=True,
    )
    return probe.returncode == 0


def link_flags() -> List[str]:
    """The ``-l`` flags for the optional libraries whose headers exist."""
    return [f for header, libs in OPTIONAL_LIBRARIES if has_header(header) for f in libs]


def _stale() -> bool:
    return not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime


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
            cmd = ["g++", *FLAGS, str(SOURCE), "-o", tmp, *link_flags()]
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
