"""The check's controls fail every cell on the card, at the cell's own size.

Needs an NVIDIA card (marked ``gpu``; skips elsewhere): for each cell of
``BENCHMARK.json``, on three seeds, the program's int8 path in place of the
bfloat16 program must fail one of the cell's gap numbers, and the reference
vocoder in TF32 in place of the served audio must fail ``audio_err``; in a
clone's cell, the reference encoders in TF32 in place of the served prompt
must fail its ``xvector_err`` or ``speech_code_gap_mean``. Run on
the card with ``python -m pytest bench_port/tests/test_bench_port_control.py``.
"""

import json

import pytest
import torch

from bench_port import control
from bench_port.harness import spec

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 501, 2**31 + 502, 2**31 + 503)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail(name):
    if not torch.cuda.is_available():
        pytest.skip("the controls run on an NVIDIA card")
    s = spec.load(name, ROOT)
    limits = {k: v["limit"] for k, v in s.limits.items()}
    dev = torch.device("cuda:0")
    for seed in SEEDS:
        _, cases = control.readings(s, seed, 15.0, dev, False)
        assert control.tf32_audio_err(s.dims, seed, dev, cases) > limits["audio_err"]
        int8, _ = control.readings(s, seed, 15.0, dev, True)
        assert any(int8[k] > v for k, v in limits.items() if k != "audio_err")
        if any("clip" in case for case in cases):
            enc = control.tf32_encoder_readings(s.dims, seed, dev, cases)
            assert any(enc[k] > v for k, v in limits.items() if k in enc)
