"""Per-layer readings shared by the metric files of several cells (``metrics/<name>.py``).

A quantity that cells moving different end-to-end metrics both report has a
metric file for each (``kernels_per_frame`` and ``kernels_per_frame.stream``);
both read it here. Each returns None where the run has nothing to read.
"""

from __future__ import annotations

from .roofline import PEAK_OPS_PER_S, request_flops


def kernels_per_frame(run):
    """Device kernels in the traced window (torch.profiler) over the frames made in it."""
    if run.trace is None or not run.frames:
        return None
    kernels = len(run.trace.kernels())
    return kernels / run.frames if kernels else None


def host_reads_per_frame(run):
    """Reads of a tensor's value by the host over the traced window (the
    benchmark's copy of ``TransferAudit``) over the frames made in it."""
    if run.host_reads is None or not run.frames:
        return None
    return run.host_reads / run.frames


def device_idle_share(run):
    """The share of the traced window with no operation on the device, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def mfu(run):
    """The whole step's share of the card's peak: the model FLOPs of every
    request completed in the traced window (``roofline.request_flops``, at
    the counts of its prompt layout: ``program.Served.layout``) over
    the window's seconds times 989 TFLOP/s, the bf16 dense peak; the f32
    vocoder's FLOPs count once against the same peak. In %."""
    if run.trace is None or not run.served:
        return None
    flops = sum(request_flops(run.dims, s.frames, len(r.text_ids), **s.layout) for r, s in run.done if s.error is None)
    return 100.0 * flops / (run.window_s * PEAK_OPS_PER_S["bf16"])
