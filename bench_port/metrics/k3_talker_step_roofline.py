"""Kernel 3 (``csrc/talker_step.cu``): the mean bound of the window's decode steps (the weights once and the cache
rows each step reads; ``roofline.talker_step_bound_ms``) over the mean device time of its launches, in %."""

from bench_port.harness.roofline import talker_step_bound_ms

PROMPT_ROWS = 10  # a CustomVoice prompt


def read(run):
    launches = run.trace.kernels("talker_step_kernel") if run.trace else []
    if not launches or not run.frames:
        return None
    # A request of n frames runs n decode steps, writing cache rows 10 .. 10 + n - 1.
    bounds = [talker_step_bound_ms(run.dims, PROMPT_ROWS + i) for s in run.served for i in range(s.frames)]
    mean_ms = sum(op[2] for op in launches) / len(launches) / 1e6
    return 100.0 * (sum(bounds) / len(bounds)) / mean_ms
