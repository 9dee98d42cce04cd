"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by one ``nvcc`` call into
``build/lib<name>.so`` at the root of the checkout (git-ignored), with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds.  A library is
rebuilt when a source in ``csrc/`` is newer than it.  Every C entry returns
``cudaGetLastError()``; ``check`` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
KERNELS = ("styleconv", "adain", "styleconv_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS, force: bool = False) -> List[str]:
    """Compile the named kernels that are missing or stale, one ``nvcc``
    per source, all started together.  Returns the names compiled."""
    todo = [n for n in names if force or _stale(n)]
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = BUILD / f".lib{name}.{os.getpid()}.so"
        proc = subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, tmp, proc))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: (argtypes), all returning int.
SIGNATURES = {
    "styleconv": {
        # x, w, bias, noise, noise_w, gamma, beta, out, hv, part_mean,
        # part_m2, scale_shift, mean_out, inv_out, n, h, w, cin, cout, then
        # the tile plan bm, bn, th, tw, spt, stages, smem; eps, dtype,
        # stream
        "styleconv_forward": [_P] * 14 + [_I] * 12 + [_F, _I, _P],
    },
    "adain": {
        # x, noise, noise_w, gamma, beta, out, hv, mean_out, inv_out,
        # part_mean, part_m2, scale_shift, n, hw, c, eps, vec, dtype, stream
        "adain_forward": [_P] * 12 + [_I] * 3 + [_F, _I, _I, _P],
    },
    "styleconv_bwd": {
        # dy, hv, mean, inv, gamma, noise, noise_w, dpre, dnoise, dgamma,
        # dbeta, dbias_dnw, scratch, n, hw, c, then the plan groups, pixels,
        # steps, tiles; vec, dtype, stream
        "styleconv_backward": [_P] * 13 + [_I] * 9 + [_P],
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.byogan_error_string.argtypes = [ctypes.c_int]
        lib.byogan_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if code != 0:
        msg = lib.byogan_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


if __name__ == "__main__":
    print("built:", build(force=True))
