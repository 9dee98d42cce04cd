"""Training-curve plot CLI (byogan_tpu/cli/plot.py).

    python -m byogan_tpu_torch.cli.plot out/metrics.jsonl [run2/] -o curves.png [--title T]

Renders one or more ``metrics.jsonl`` files (``train/metrics.py``; a run's
output directory also works) into one PNG: loss curves with stage
boundaries, throughput on a twin axis, and, when the run logged periodic
evaluations (``eval_step``), the SWD trajectory with MS-SSIM diversity on
a twin axis.  Several files overlay for comparison.  The same figure as
the JAX package's.  It needs matplotlib, imported only here, inside
``main``: a host tool for wherever the metrics file is.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot metrics.jsonl curves")
    parser.add_argument(
        "metrics", nargs="+",
        help="metrics.jsonl path(s); a run's output dir also works",
    )
    parser.add_argument(
        "-o", "--output", default="curves.png", help="output PNG path"
    )
    parser.add_argument(
        "--title", default=None, help="figure title (default: file name)"
    )
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from byogan_tpu_torch.train.metrics import read_metrics

    paths = []
    for p in args.metrics:
        if os.path.isdir(p):
            p = os.path.join(p, "metrics.jsonl")
        if not os.path.exists(p):
            raise SystemExit(f"no metrics file at {p}")
        paths.append(p)

    any_eval = False
    runs = []
    for p in paths:
        records = read_metrics(p)
        losses = [r for r in records if "c_loss" in r]
        evals = [r for r in records if r.get("kind") == "eval"]
        any_eval = any_eval or bool(evals)
        runs.append((os.path.basename(os.path.dirname(p)) or p, losses, evals))

    n_rows = 2 if any_eval else 1
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(9, 4 * n_rows), sharex=True, squeeze=False
    )
    ax_loss = axes[0][0]
    for name, losses, _ in runs:
        if not losses:
            continue
        iters = [r["iter"] for r in losses]
        label = f" ({name})" if len(runs) > 1 else ""
        ax_loss.plot(iters, [r["c_loss"] for r in losses],
                     label=f"critic loss{label}")
        ax_loss.plot(iters, [r["g_loss"] for r in losses],
                     label=f"generator loss{label}")
        # stage boundaries: first record of each stage
        seen = set()
        for r in losses:
            if r["stage"] not in seen:
                seen.add(r["stage"])
                if len(seen) > 1:
                    ax_loss.axvline(r["iter"], color="gray", lw=0.6, ls=":")
    ax_loss.set_ylabel("loss (window mean)")
    ax_loss.legend(fontsize=8, loc="upper left")
    ax_loss.grid(alpha=0.25)
    # Throughput on a twin axis (the per-window images/sec readout).
    ax_tp = ax_loss.twinx()
    for name, losses, _ in runs:
        pts = [r for r in losses if r.get("images_per_sec", 0) > 0]
        if not pts:
            continue
        label = f" ({name})" if len(runs) > 1 else ""
        ax_tp.plot(
            [r["iter"] for r in pts],
            [r["images_per_sec"] for r in pts],
            color="tab:green", alpha=0.45, lw=1.0,
            label=f"img/s{label}",
        )
    ax_tp.set_ylabel("images/sec", color="tab:green")
    ax_tp.tick_params(axis="y", labelcolor="tab:green")

    if any_eval:
        ax_eval = axes[1][0]
        for name, _, evals in runs:
            if not evals:
                continue
            iters = [r["iter"] for r in evals]
            label = f" ({name})" if len(runs) > 1 else ""
            ax_eval.plot(iters, [r["swd"] for r in evals], marker="o",
                         ms=3, label=f"SWD x1e3{label}")
            if all("swd_ema" in r for r in evals):
                ax_eval.plot(iters, [r["swd_ema"] for r in evals],
                             marker="o", ms=3,
                             label=f"SWD x1e3, EMA{label}")
        ax_eval.set_ylabel("SWD x1e3 (lower = better; per-stage scale)")
        # MS-SSIM diversity (mode-collapse readout, [0,1]) on a twin axis
        # when the eval records carry it; real-set anchor dashed.
        if any(
            evals and all("msssim" in r for r in evals)
            for _, _, evals in runs
        ):
            ax_div = ax_eval.twinx()
            for name, _, evals in runs:
                if not evals or not all("msssim" in r for r in evals):
                    continue
                iters = [r["iter"] for r in evals]
                label = f" ({name})" if len(runs) > 1 else ""
                ax_div.plot(iters, [r["msssim"] for r in evals],
                            color="tab:purple", alpha=0.7, ms=2, marker="o",
                            label=f"MS-SSIM fake{label}")
                if all("msssim_ema" in r for r in evals):
                    # the EMA shadow's diversity — the weights sampling
                    # actually serves (mirrors the SWD/SWD-EMA pairing)
                    ax_div.plot(iters, [r["msssim_ema"] for r in evals],
                                color="orchid", alpha=0.7, ms=3, marker="^",
                                lw=1.0, label=f"MS-SSIM fake, EMA{label}")
                if all("msssim_real" in r for r in evals):
                    ax_div.plot(iters, [r["msssim_real"] for r in evals],
                                color="tab:purple", alpha=0.5, ls="--",
                                label=f"MS-SSIM real{label}")
            ax_div.set_ylim(0.0, 1.05)
            ax_div.set_ylabel(
                "MS-SSIM diversity (1.0 = collapse)", color="tab:purple"
            )
            ax_div.tick_params(axis="y", labelcolor="tab:purple")
            ax_div.legend(fontsize=8, loc="upper right")
        ax_eval.legend(fontsize=8, loc="upper left")
        ax_eval.grid(alpha=0.25)

    axes[-1][0].set_xlabel("iteration")
    fig.suptitle(args.title or ", ".join(n for n, _, _ in runs))
    fig.tight_layout()
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    fig.savefig(args.output, dpi=120)
    plt.close(fig)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
