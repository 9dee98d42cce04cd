"""Profiler traces, wall timers and named regions (byogan_tpu/profiling.py).

``trace_if(dir)`` records a ``torch.profiler`` trace of its block, the
host's ops and, where a GPU is present, the card's kernels (K1, K2 and K3
among them), and writes it into ``dir`` as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``), which Perfetto and TensorBoard's
profiler plugin open.  It does nothing when the directory is falsy and
``BYOGAN_TRACE_DIR`` is unset:

    with trace_if("/tmp/trace"):
        run_steps(...)

or ``BYOGAN_TRACE_DIR=/tmp/trace python -m byogan_tpu_torch.cli.main ...``.
``annotate(name)`` marks a region of the timeline; the training loop marks
each iteration.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str] = None) -> Iterator[None]:
    trace_dir = trace_dir or os.environ.get("BYOGAN_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


@contextlib.contextmanager
def step_timer(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock timer; records into ``sink[name]`` seconds if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = dt


def annotate(name: str) -> torch.profiler.record_function:
    """Named profiler region (shows up in the trace timeline)."""
    return torch.profiler.record_function(name)
