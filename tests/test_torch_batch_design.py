"""Batched voice design, sequential ICL and mixed layouts, the port against the JAX package (f32, CPU).

``test_torch_batch_clone.py``'s models (``WideTokenizer``: texts and
instructs of different lengths) and comparison (frames token-exact, audio
within atol 1e-5 of the JAX package's ``synthesize_batch``, greedy and PCG):
voice design with instructs of different lengths (each stream's prefill
ends at its own ``instruct_len + 9``), ICL clones in the sequential layout
(prefill at ``9 + n_text + n_codec``, per-stream caps), and one call holding
all three layouts, which runs one loop a layout in the order of first
appearance and puts every stream back in its place.
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu_torch.pipeline as TP
from test_torch_batch import TEMPERATURES, check_batch, port_frames
from test_torch_batch_clone import ICL_TEXTS, icl_prompts, low_icl_floor, wide_models  # noqa: F401

torch.set_num_threads(1)

DESIGN_TEXTS = ["Design me.", "A second designed voice says this."]
INSTRUCTS = ["a calm, low voice", "bright"]  # ChatML-framed: 40 and 34 tokens


@pytest.fixture(scope="module")
def models():
    return wide_models()


@pytest.fixture(scope="module")
def prompts(models):
    return icl_prompts(*models)


@TEMPERATURES
def test_design_batch_matches_jax(models, temperature):
    jm, tm = models
    check_batch(jm, tm, DESIGN_TEXTS, instructs=INSTRUCTS, max_length=12, seed=42, temperature=temperature)
    group = tm._prepare_batch_group("design", DESIGN_TEXTS, ["ryan"] * 2, ["english"] * 2, INSTRUCTS,
                                    TP.SynthesisOptions(max_length=12), [0, 1])
    assert group.state.pos.tolist() == [40 + 9, 34 + 9]


@TEMPERATURES
def test_icl_sequential_batch_matches_jax(models, prompts, low_icl_floor, temperature):
    jm, tm = models
    frames, _ = check_batch(jm, tm, ICL_TEXTS, prompts[0], prompts[1], max_length=16, seed=42,
                            temperature=temperature, icl_sequential=True)
    assert [len(f) for f in frames] == [6, 16]
    group = tm._prepare_batch_group("icl", ICL_TEXTS, prompts[1], ["english"] * 2, [None] * 2,
                                    TP.SynthesisOptions(max_length=16, icl_sequential=True), [0, 1])
    n_text = [len(p.ref_text_ids) + len(tm.tokenizer.encode(t)) + 1 for p, t in zip(prompts[1], ICL_TEXTS)]
    assert group.state.pos.tolist() == [9 + n_text[0] + 17, 9 + n_text[1] + 11]


@TEMPERATURES
def test_mixed_layouts_match_jax(models, prompts, low_icl_floor, temperature):
    """Design, preset, ICL (sequential), preset, design, ICL in one call:
    three groups in the order of first appearance, each stream in its
    place, each equal to its group run alone."""
    jm, tm = models
    texts = [DESIGN_TEXTS[0], "Hi", ICL_TEXTS[0], "A preset speaker here.", DESIGN_TEXTS[1], ICL_TEXTS[1]]
    jspk = ["ryan", "ryan", prompts[0][0], "serena", "ryan", prompts[0][1]]
    tspk = ["ryan", "ryan", prompts[1][0], "serena", "ryan", prompts[1][1]]
    instructs = [INSTRUCTS[0], None, None, None, INSTRUCTS[1], None]
    seeds = [42, 7, 42, 8, 43, 43]
    assert tm._split_batch_groups(tspk, instructs) == [("design", [0, 4]), ("basic", [1, 3]), ("icl", [2, 5])]
    frames, audio = check_batch(jm, tm, texts, jspk, tspk, seeds=seeds, instructs=instructs, max_length=16,
                                seed=42, temperature=temperature, icl_sequential=True)
    opts = TP.SynthesisOptions(max_length=16, temperature=temperature, icl_sequential=True)
    for idx in ([0, 4], [1, 3], [2, 5]):
        alone = port_frames(tm, [texts[i] for i in idx], [tspk[i] for i in idx], "english", opts,
                            [seeds[i] for i in idx], [instructs[i] for i in idx])
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(frames[i], alone[j])
