"""The roofline counts reproduce the bounds of the port's kernel table at the 1.7B widths."""

import json

import pytest

from bench_port.harness import roofline, spec
from bench_port.harness.spec import BENCH_DIR


def dims(size):
    return spec.dims(json.loads((BENCH_DIR / "configs" / f"qwen3-tts-12hz-{size}-customvoice.json").read_text()))


def test_kernel_bounds_at_1p7b():
    d = dims("1.7b")
    assert roofline.cp_frame_bound_ms(d) == pytest.approx(0.0670, abs=5e-5)
    # 160 rows: the table's last trial writes row 114, reading 115.
    assert roofline.talker_step_bound_ms(d, 114) == pytest.approx(0.8454, abs=5e-5)
    assert roofline.talker_step_bound_ms(d, 2034) == pytest.approx(0.9111, abs=5e-5)
    assert roofline.residual_unit_chunk_bound_ms(10) == pytest.approx(0.1887, abs=5e-5)
    assert roofline.residual_unit_chunk_bound_ms(4) == pytest.approx(0.0755, abs=5e-5)


def test_kernel3_reads_a_third_at_0p6b():
    big, small = dims("1.7b"), dims("0.6b")
    ratio = roofline.talker_step_bound_ms(small, 0) / roofline.talker_step_bound_ms(big, 0)
    assert 0.3 < ratio < 0.34
    assert roofline.cp_frame_bound_ms(small) < roofline.cp_frame_bound_ms(big)


def test_request_flops_grow_with_frames():
    d = dims("1.7b")
    a, b = roofline.request_flops(d, 25, 6), roofline.request_flops(d, 125, 40)
    # About 10.5 GFLOP a frame at 1.7B: talker 2.8, code predictor 2.6, vocoder 5.
    assert 9e9 < (b - a) / 100 < 12e9
