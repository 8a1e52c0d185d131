"""Batched synthesis on the weight-only int8 tree, the port against the JAX package (CPU).

``test_torch_batch.py``'s tiny Base model, quantized by each package from
the same f32 trees (``quantize_int8=True``: talker and code predictor fused,
then quantized, bit for bit alike). The JAX package's batched programs
strip its stream packs and multiply through its dequant-then-dot; the
port's batched loop runs the layer path through ``quant.mm`` (kernel 4's
plain version here, at the B folded rows). ``synthesize_batch``: frames
token-exact and audio within atol 1e-5, greedy and PCG; and the port's
batched streams against its own batch-1 runs (which decode on the fused
int8 tree's whole-step path: kernel 3's and kernel 1's plain versions).
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_torch_batch import TEMPERATURES, TEXTS, check_batch, port_frames
from test_torch_voice_clone import build_models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def int8_models():
    jm, tm = build_models()
    j8 = JP.Qwen3TTS(jm.config, jm.talker_params, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                     vocoder_config=jm.vocoder_config, quantize_int8=True)
    t8 = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                  vocoder_config=tm.vocoder_config, quantize_int8=True)
    assert t8.talker_params["layers"]["qkv_proj"]["q8"].dtype == torch.int8
    assert t8.cp_params["lm_heads"]["q8"].dtype == torch.int8
    return j8, t8


@TEMPERATURES
def test_int8_batch_matches_jax(int8_models, temperature):
    jm, tm = int8_models
    check_batch(jm, tm, TEXTS, ["ryan", "serena", "ryan"], ["ryan", "serena", "ryan"], max_length=12, seed=42,
                temperature=temperature)


def test_int8_batch_streams_equal_solo_runs(int8_models):
    _, tm = int8_models
    opts = SynthesisOptions(max_length=12, seed=3)
    frames = port_frames(tm, TEXTS, "ryan", "english", opts, None, None)
    for i, text in enumerate(TEXTS):
        solo = tm._custom_voice_session(text, "ryan", "english", SynthesisOptions(max_length=12, seed=3 + i))
        np.testing.assert_array_equal(frames[i], solo.run_to_completion())
