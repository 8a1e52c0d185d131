"""Kernel 2's stream entry (``csrc/residual_unit.cu``): the bound of every chunk the window's streams handed back
(3xTF32 operations of the chunk's own frames, its 9 units; ``roofline.residual_unit_chunk_bound_ms``) over the
summed device time of the kernel's launches, in %."""

from bench_port.harness.roofline import residual_unit_chunk_bound_ms


def read(run):
    launches = run.trace.kernels("residual_unit") if run.trace else []
    chunks = [f for s in run.served for f in s.chunks if f]
    if not launches or not chunks:
        return None
    return 100.0 * sum(residual_unit_chunk_bound_ms(f) for f in chunks) / (sum(op[2] for op in launches) / 1e6)
