#!/usr/bin/env python3
"""Time variants of K3, the epilogue's backward kernel, at the 16 stage-8
shapes on one GPU: the pixel steps whose loads a thread issues together
(``kUnroll``), the blocks an SM must hold (``__launch_bounds__``' second
argument, which caps the registers), the threads of the merge passes
(``kMergeThreads``) and the blocks ``plan_backward`` aims at.

    python3 tools/sweep_k3.py [--batch 5] [--unroll 1 2 4] [--min-blocks 0 4]
                              [--merge-threads 256 1024] [--targets 132 264 528]

Each (unroll, min-blocks, merge-threads) is ``csrc/styleconv_bwd.cu`` with
those constants replaced, compiled (all at once) into ``build/exp/`` and
loaded in place of the built K3; each runs under each block target.  Every variant is
first held against ``styleconv_backward_plain`` at every shape (bf16).
Prints the card's time per call (torch.profiler) by shape and summed, bf16.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--unroll", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[0, 4])
    ap.add_argument("--merge-threads", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--targets", type=int, nargs="+", default=[132, 264, 528])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k3: needs a CUDA device")
    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.ops import styleconv_bwd as k3
    from byogan_tpu_torch.ops.cardcheck import kernel_ms

    src = (build.CSRC / "styleconv_bwd.cu").read_text()
    if not (re.search(r"kUnroll = \d+;", src) and re.search(r"kMergeThreads = \d+;", src)
            and "__launch_bounds__(kThreads)" in src):
        raise SystemExit("sweep_k3: the source no longer has the constants this sweep replaces")
    exp = build.BUILD / "exp"
    exp.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u, mb, mt in itertools.product(args.unroll, args.min_blocks, args.merge_threads):
        text = re.sub(r"kUnroll = \d+;", f"kUnroll = {u};", src)
        text = re.sub(r"kMergeThreads = \d+;", f"kMergeThreads = {mt};", text)
        if mb:
            text = text.replace("__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {mb})")
        cu, lib = exp / f"k3_u{u}_b{mb}_m{mt}.cu", exp / f"libk3_u{u}_b{mb}_m{mt}.so"
        cu.write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(cu)]
        procs[(u, mb, mt)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sweep_k3: nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in build.SIGNATURES["styleconv_bwd"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        lib.byogan_error_string.argtypes, lib.byogan_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        libs[key] = lib

    dev, n = torch.device("cuda"), args.batch
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(r, cout) for r, _, cout in ModelSpec().styleconv_shapes()] + [(4, 512)]
    inputs = []
    for r, c in shapes:
        hv = torch.randn((n, r, r, c), generator=gen, device=dev) + 0.1
        inputs.append((
            torch.randn((n, r, r, c), generator=gen, device=dev).bfloat16(), hv, hv.mean(dim=(1, 2)),
            torch.rsqrt(hv.var(dim=(1, 2), unbiased=False) + 1e-8),
            (1 + 0.1 * torch.randn((n, c), generator=gen, device=dev)).bfloat16(),
            torch.randn((n, r, r, 1), generator=gen, device=dev).bfloat16(),
            0.3 * torch.randn((c,), generator=gen, device=dev),
        ))
    print(f"{torch.cuda.get_device_name(0)}; K3 variants, bf16, batch {n}; device ms per call (torch.profiler)")
    print("unroll min_blocks merge_threads target | " + " ".join(f"{r}px/{c}" for r, c in shapes) + " | sum")
    for (u, mb, mt), lib in libs.items():
        for target in args.targets:
            with mock.patch.object(build, "load", lambda name, lib=lib: lib), mock.patch.object(k3, "TARGET_BLOCKS", target):
                k3.plan_backward.cache_clear()
                times = []
                for (r, c), a in zip(shapes, inputs):
                    got, want = k3.styleconv_backward_cuda(*a), k3.styleconv_backward_plain(*a)
                    for f in want._fields:
                        g, w = getattr(got, f).float(), getattr(want, f).float()
                        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
                        if not err <= 3e-2:
                            raise SystemExit(f"sweep_k3: variant {(u, mb, mt)}: ({n},{r},{r},{c}) {f} off by {err:.3e}")
                    times.append(sum(kernel_ms(lambda: k3.styleconv_backward_cuda(*a)).values()))
            k3.plan_backward.cache_clear()
            print(f"{u} {mb} {mt} {target} | " + " ".join(f"{t:.4f}" for t in times) + f" | {sum(times):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
