"""Rolling-loss readout and ``metrics.jsonl`` (byogan_tpu/train/metrics.py:18-110).

Same console lines and the same jsonl records as the JAX package: one
``{"iter", "stage", "epoch", "c_loss", "g_loss", "images_per_sec", ...}``
object per readout and one ``{"kind": "eval", "iter", "stage", ...}``
object per periodic evaluation, appended and flushed.  The console line
also shows the regularizers' state (``DISPLAY_EXTRAS``) where a run has it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

#: extras of a readout that the console line shows too: augmentation, ADA
#: and path-length regularization state
DISPLAY_EXTRAS = ("aug_p", "rt_ema", "pl_ema", "pl_penalty")


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, print_fn=print):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._print = print_fn
        self._last_time = time.perf_counter()
        self._last_iters = 0

    def log_step(
        self,
        iters: int,
        c_loss: float,
        g_loss: float,
        epoch: int,
        stage: int,
        batch: int,
        extra: Optional[Dict[str, float]] = None,
    ) -> None:
        """Record one readout of window-averaged losses."""
        now = time.perf_counter()
        rate = (
            (iters - self._last_iters) * batch / (now - self._last_time)
            if now > self._last_time and iters > self._last_iters
            else 0.0
        )
        self._last_time, self._last_iters = now, iters
        shown = "".join(f"  {k}: {extra[k]:.4g}" for k in DISPLAY_EXTRAS if k in (extra or {}))
        self._print(
            f"step {stage} iter {iters}  g_loss: {g_loss:.3}  c_loss: {c_loss:.3}  "
            f"epoch: {epoch + 1}  ({rate:.1f} img/s){shown}"
        )
        if self._jsonl:
            rec = {
                "iter": iters, "stage": stage, "epoch": epoch, "c_loss": float(c_loss),
                "g_loss": float(g_loss), "images_per_sec": rate, **(extra or {}),
            }
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def log_eval(self, iters: int, stage: int, values: Dict[str, float]) -> None:
        """Record a periodic evaluation readout (SWD and MS-SSIM) as its own
        ``{"kind": "eval"}`` record, so that readers of the loss records
        can tell the two apart."""
        readout = "  ".join(f"{k}: {v:.6g}" for k, v in values.items())
        self._print(f"eval step {stage} iter {iters}  {readout}")
        if self._jsonl:
            rec = {"kind": "eval", "iter": iters, "stage": stage, **values}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


def read_metrics(path: str, kind: Optional[str] = None) -> List[Dict]:
    """The records of a metrics.jsonl file; ``kind="eval"`` keeps the
    periodic evaluations only, None keeps everything."""
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                records.append(rec)
    return records
