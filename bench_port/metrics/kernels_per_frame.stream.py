"""Device kernels in the traced window (torch.profiler) over the frames made in it. Moves ttfa_p90_ms, in the stream cell."""

from bench_port.harness.readings import kernels_per_frame


def read(run):
    return kernels_per_frame(run)
