"""Kernel 2's stream entry (``csrc/residual_unit.cu``) in an in-context clone's streams: the bound of every chunk the
window's streams handed back and of every piece of their reference prefixes (the ``frames`` of each ``q3.piece`` span;
3xTF32 operations of the frames' own rows, 9 units; ``roofline.residual_unit_chunk_bound_ms``) over the summed device
time of the kernel's launches, in %. Moves ttfa_p90_ms. None where the program records no ``q3.piece`` span."""

from bench_port.harness.clone_spans import residual_unit_roofline_icl


def read(run):
    return residual_unit_roofline_icl(run)
