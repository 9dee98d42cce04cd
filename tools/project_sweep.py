#!/usr/bin/env python3
"""Full-width projection trajectories and the projection gradient's
sensitivity to rounding, on one GPU.

    python3 tools/project_sweep.py

Trains the full-width generator as chip_smoke.py's EMA slice does (the
training CLI, EMA 0.999, style mixing 0.9, one epoch a stage on 24
synthetic images) and, on FINAL.pth's EMA weights, projects in W from the
mean w onto a target rendered from a known w (``chip_smoke.
projection_setup``) in f32 and bf16, for 200 and 400 iterations, at lr 0.05
and 0.1, printing each loss trajectory and its last/first ratio.  Then, in
f32 with TF32 off, one projection iteration's gradient with respect to w on
the kernel path against the plain path, and the plain path against itself
at w moved by 1e-6 relative (rounding alone), on FINAL's EMA weights and on
four random-init generators (noise weights 0 and 0.3), at the mean w and
0.3 away from it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grad_errors(gen, target, noise, w0, rng):
    """(kernel vs plain, rounding alone): relative L2 and max of dL/dw."""
    import torch

    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import styleconv_plain
    from byogan_tpu_torch.projector import projection_loss

    out = {}
    for path in ("kernel", "plain", "moved"):
        w = w0 * (1 + 1e-6 * torch.randn(w0.shape, generator=rng, device="cuda")) if path == "moved" else w0
        w = w.clone().requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            out[path] = torch.autograd.grad(projection_loss(gen, w, target, noise, 8), w)[0]
    errs = []
    for path in ("kernel", "moved"):
        d = (out[path] - out["plain"]).double()
        errs.append((float(d.norm() / out["plain"].double().norm()), float(d.abs().max() / out["plain"].abs().max())))
    return errs


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("project_sweep: needs a CUDA device")
    import chip_smoke as cs
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
    from byogan_tpu_torch.data.synthetic import write_prepared_dataset
    from byogan_tpu_torch.models.factory import ModelSpec, build_generator
    from byogan_tpu_torch.projector import mean_w, project, synthesize_w

    with tempfile.TemporaryDirectory() as tmp:
        data = write_prepared_dataset(os.path.join(tmp, "data"), cs.TRAIN_IMAGES, 8, seed=0)
        cfg = os.path.join(tmp, "slice.txt")
        with open(cfg, "w") as f:
            f.write(cs.SLICE_CONFIG.format(data=data, mix=0.9, tmp=tmp))
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            train_main(["slice", "--config-file", cfg])
        final = os.path.join(tmp, "slice_ck", "FINAL.pth")
        for dtype, n, lr in (("bfloat16", 200, 0.05), ("float32", 200, 0.05), ("bfloat16", 400, 0.05),
                             ("bfloat16", 200, 0.1)):
            s, target, _ = cs.projection_setup(final, 2, dtype)
            t0 = time.perf_counter()
            losses = project(s.generator, target, 8, s.z_dim, n_iters=n, lr=lr).losses.cpu().numpy()
            print(f"project W full width {dtype}, {n} iterations, lr {lr}: "
                  + ", ".join(f"{i}: {losses[i]:.4f}" for i in range(0, n, n // 8))
                  + f", last {losses[-1]:.4f}; last/first {losses[-1] / losses[0]:.4f} "
                  f"({time.perf_counter() - t0:.2f} s) {cs.math_flags()}", flush=True)

        with cs.strict_f32():
            s, target, noise = cs.projection_setup(final, 2, "float32")
            gens = [("FINAL.pth EMA", s.generator, target, noise)]
            for seed, noise_w in ((0, 0.0), (1, 0.0), (2, 0.3), (3, 0.3)):
                gen = build_generator(ModelSpec(), generator=torch.Generator().manual_seed(seed))
                with torch.no_grad():
                    for name, p in gen.named_parameters():
                        if "inject_noise" in name and noise_w:
                            p.normal_(0.0, noise_w, generator=torch.Generator().manual_seed(len(name)))
                gen.cuda().requires_grad_(False)
                with torch.no_grad():
                    w_true = gen.map_latent(
                        truncated_noise(torch.Generator(device="cuda").manual_seed(11), 2, 512)).float()
                    noise = synthesis_noise(torch.Generator(device="cuda").manual_seed(0), 2, 8)
                    gens.append((f"random init {seed}, noise weights {noise_w}", gen,
                                 synthesize_w(gen, w_true, noise, 8), noise))
            rng = torch.Generator(device="cuda").manual_seed(7)
            for name, gen, target, noise in gens:
                w0 = mean_w(gen, 512).expand(2, -1)
                for where, w in (("mean w", w0), ("mean w + 0.3 N(0,1)",
                                                  w0 + 0.3 * torch.randn(w0.shape, generator=rng, device="cuda"))):
                    (k2, kmax), (m2, mmax) = grad_errors(gen, target, noise, w, rng)
                    print(f"dL/dw f32 {name}, {where}: kernel vs plain relative L2 {k2:.3e}, max {kmax:.3e}; "
                          f"rounding alone {m2:.3e}, {mmax:.3e} {cs.math_flags()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
