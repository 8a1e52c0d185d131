"""Profiling: ``torch.profiler`` traces and named regions.

The port's counterpart of ``trace`` and ``annotate`` in
``qwen3_tts_tpu/profiling.py`` (the CLI's ``--profile``):

* ``trace(dir)`` records everything inside the context, the host's
  activity and, when a CUDA card is present, its kernels, and writes a
  Chrome trace to ``dir/trace.json`` (open it in ui.perfetto.dev or
  chrome://tracing);
* ``annotate(name)`` adds a named region visible in the trace.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a ``torch.profiler`` trace into ``log_dir/trace.json``; yields
    the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("prefill"): ...``."""
    return record_function(name)
