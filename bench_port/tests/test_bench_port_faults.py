"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the program (on the CPU, at the tiny cell's size) where
the cell can have it: a code altered where it is produced, a decode step that
returns its state unchanged, the audio altered where it is produced; and in a
clone's cells, its prompt altered where it is made (the x-vector, one of the
reference codes), the reference codes left out of the vocoder's context, and
the repetition penalty an in-context clone runs under left out. Each clone
fault must be caught by the number it names. The faults of a batch (half of
it left out) and of several chips (their exchange left out) have no place in
these one-stream, one-chip cells.
"""

import json
import time

import numpy as np
import pytest
import torch

import qwen3_tts_tpu_torch.models.code_predictor as cp_module
import qwen3_tts_tpu_torch.models.codec.vocoder as vocoder_module
import qwen3_tts_tpu_torch.models.talker as talker_module
import qwen3_tts_tpu_torch.ops.sampling as sampling_module
import qwen3_tts_tpu_torch.pipeline as pipeline_module
from bench_port.harness import cell, spec
from qwen3_tts_tpu_torch.models.codec.encoder import Encoder12Hz
from qwen3_tts_tpu_torch.models.speaker import SpeakerEncoder


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


def perturbed_xvector(orig):
    def fault(self, samples):
        x = orig(self, samples)
        return x + 1e-3 * abs(x).max() * (-1.0) ** np.arange(x.shape[0])
    return fault


def altered_reference_code(orig):
    def fault(self, samples):
        codes = orig(self, samples).copy()
        codes[len(codes) // 2, 3] = (codes[len(codes) // 2, 3] + 1) % self.cfg.codebook_size
        return codes
    return fault


def no_prefix(orig):
    def fault(self, prefix, chunk):
        return None
    return fault


def no_penalty(orig):
    def fault(logits, penalty_mask, penalty):
        return logits
    return fault


# A clone's faults: where each is planted and the number that must catch it.
CLONE_FAULTS = {
    "x-vector perturbed": (SpeakerEncoder, "encode", perturbed_xvector, "xvector_err"),
    "a reference code altered": (Encoder12Hz, "encode", altered_reference_code, "speech_code_gap_mean"),
    "reference codes left out of the vocoder": (pipeline_module.StreamingSession, "_feed_prefix", no_prefix,
                                                "audio_err"),
    "repetition penalty left out": (sampling_module, "apply_repetition_penalty", no_penalty, "talker_gap_mean"),
}
# The cells that can have each: an x-vector clone has no reference codes and
# runs under the penalty it asks for.
ICL_CELLS = ["tiny-icl-stream-cell", "tiny-icl-seq-utterances-cell"]
CLONE_CASES = [(name, fault) for fault in sorted(CLONE_FAULTS) for name in ICL_CELLS] + [
    ("tiny-xvector-utterances-cell", "x-vector perturbed")]


@pytest.mark.parametrize("name,fault", CLONE_CASES)
def test_clone_fault_is_caught_by_its_number(tiny_checkout, monkeypatch, name, fault):
    owner, attr, make, number = CLONE_FAULTS[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    torch.set_num_threads(2)
    root, _ = tiny_checkout
    if fault == "repetition penalty left out":
        # The penalty moves a greedy code only where the talker would pick one
        # it picked before: the tiny talker does so within 60-72 frames.
        path = root / "bench_port" / "traffic" / f"{name.removesuffix('-cell')}.json"
        mix = json.loads(path.read_text())
        path.write_text(json.dumps(dict(mix, frames=[60, 72], strata=2, warmup=[[66, 8]])))
    line, _ = cell.run(spec.load(name, root), 2**31 + 99, 1.5, False, "cpu", time.perf_counter())
    assert line["correct"] is False
    value, limit = line["compared"][number]
    assert value > limit, (number, value, limit)
