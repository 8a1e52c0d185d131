"""Kernel 1 (``csrc/cp_frame.cu``): its bound a frame (every byte read once; ``roofline.cp_frame_bound_ms``) over the
mean device time of its launches in the traced window, in %."""

from bench_port.harness.roofline import cp_frame_bound_ms


def read(run):
    launches = run.trace.kernels("cp_frame_kernel") if run.trace else []
    if not launches:
        return None
    mean_ms = sum(op[2] for op in launches) / len(launches) / 1e6
    return 100.0 * cp_frame_bound_ms(run.dims) / mean_ms
