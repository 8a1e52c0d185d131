"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the program (on the CPU, at the tiny cell's size) where
the cell can have it: a code altered where it is produced, a decode step that
returns its state unchanged, the audio altered where it is produced. The
faults of a batch (half of it left out) and of several chips (their exchange
left out) have no place in these one-stream, one-chip cells.
"""

import json
import time

import pytest
import torch

import qwen3_tts_tpu_torch.models.code_predictor as cp_module
import qwen3_tts_tpu_torch.models.codec.vocoder as vocoder_module
import qwen3_tts_tpu_torch.models.talker as talker_module
import qwen3_tts_tpu_torch.ops.sampling as sampling_module
from bench_port.harness import cell, spec


def altered_acoustic(orig):
    def fault(*args, **kwargs):
        return (orig(*args, **kwargs) + 1) % 2048
    return fault


def altered_semantic(orig):
    def fault(*args, **kwargs):
        return (orig(*args, **kwargs) + 1) % 2048
    return fault


def frozen_step(orig):
    first = []

    def fault(*args, **kwargs):
        if not first:
            first.append(orig(*args, **kwargs))
        return first[0]
    return fault


def altered_audio(orig):
    def fault(*args, **kwargs):
        wav, state = orig(*args, **kwargs)
        return wav * 1.01, state
    return fault


FAULTS = {
    "acoustic code altered": (cp_module, "predict_acoustic_codes", altered_acoustic),
    "semantic code altered": (sampling_module, "sample", altered_semantic),
    "decode step returns its state unchanged": (talker_module, "decode_step", frozen_step),
    "audio altered": (vocoder_module, "decode_stream_chunk", altered_audio),
}
# The two sets of numbers the cells compare: the 1.7B cells' and the 0.6B
# cell's (all 16 codes of a frame in place of the semantic code alone).
NUMBER_SETS = {
    "talker": {"talker_gap_mean": {"limit": 1e-3}, "cp_gap_mean": {"limit": 1e-3}, "audio_err": {"limit": 1e-4}},
    "code": {"code_gap_mean": {"limit": 1e-3}, "cp_gap_mean": {"limit": 1e-3}, "audio_err": {"limit": 1e-4}},
}


@pytest.mark.parametrize("numbers", sorted(NUMBER_SETS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["tiny-utterances-cell", "tiny-stream-cell"])
def test_fault_is_not_correct(tiny_checkout, monkeypatch, name, fault, numbers):
    module, attr, make = FAULTS[fault]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    torch.set_num_threads(2)
    root, _ = tiny_checkout
    (root / "bench_port" / "limits" / f"{name}.json").write_text(json.dumps(NUMBER_SETS[numbers]))
    line, _ = cell.run(spec.load(name, root), 2**31 + 99, 1.5, False, "cpu", time.perf_counter())
    assert line["correct"] is False
    assert any(value > limit for value, limit in line["compared"].values())
