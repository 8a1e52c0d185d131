"""The clone and description paths against the plain reference at a tiny size on the CPU, and the existing cells pinned.

The program's speaker and speech encoders, built from the benchmark's trees,
against ``reference/encoders.py``; the prompt rows and trailing text that the
program's sessions assemble for an x-vector clone, an in-context clone
(overlaid and sequential) and a voice description, against
``reference/qwen3_tts.py``; the repetition penalty's rule. Then the pins: the
trees the existing configurations draw, the requests the existing mixes
plan and a preset speaker's FLOP counts are those the harness gave before
it took the clone and description layouts.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

import qwen3_tts_tpu_torch.generation.prefill as prefill_module
import qwen3_tts_tpu_torch.ops.sampling as sampling_module
from bench_port.harness import program, roofline, spec, traffic, weights
from bench_port.harness.spec import BENCH_DIR
from bench_port.reference import encoders as ref_enc
from bench_port.reference import qwen3_tts as ref

from conftest import TINY_BASE_CONFIG, TINY_BASE_MIXES, TINY_CONFIG

SEED = 2**31 + 41
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def base():
    """(dims, the three trees, the encoders' trees, the program's model, two voices)."""
    torch.set_num_threads(2)
    dims = spec.dims(TINY_BASE_CONFIG)
    trees, enc = weights.draw(dims, SEED, CPU), weights.draw_encoders(dims, SEED, CPU)
    model = program.build(dims, trees, traffic.WordTokenizer(), encoders=enc)
    mix = dict(TINY_BASE_MIXES["tiny-icl-stream"], ref_seconds=[0.7, 2.3])
    return dims, trees, enc, model, traffic.voices(mix, SEED)


def test_speaker_encoder_matches_reference(base):
    dims, _, enc, model, voices = base
    for voice in voices:
        got = torch.from_numpy(model.speaker_encoder.encode(voice.samples))
        want = ref_enc.speaker_xvector(enc["speaker_encoder"], dims["speaker_encoder"], torch.from_numpy(voice.samples))
        assert got.shape == (dims["speaker_encoder"]["enc_dim"],)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_speech_encoder_matches_reference(base):
    dims, _, enc, model, voices = base
    for voice in voices:
        got = torch.from_numpy(model.speech_encoder.encode(voice.samples).astype(np.int64))
        clip = torch.from_numpy(voice.samples)
        assert torch.equal(got, ref_enc.speech_codes(enc["speech_encoder"], dims["speech_encoder"], clip))
        gaps = ref_enc.speech_code_gaps(enc["speech_encoder"], dims["speech_encoder"], clip, got)
        assert gaps.shape == got.shape and float(gaps.max()) < 1e-6
        # Every stage picks among many codewords: the clip's level carries through.
        assert len(set(got[:, 0].tolist())) > 1


def test_speech_code_gaps_see_one_altered_code(base):
    dims, _, enc, model, voices = base
    clip = torch.from_numpy(voices[0].samples)
    codes = ref_enc.speech_codes(enc["speech_encoder"], dims["speech_encoder"], clip)
    codes[2, 5] = (codes[2, 5] + 1) % dims["speech_encoder"]["codebook_size"]
    gaps = ref_enc.speech_code_gaps(enc["speech_encoder"], dims["speech_encoder"], clip, codes)
    assert float(gaps[2, 5]) > 1e-3 and float(gaps[:2].max()) == 0.0
    assert ref_enc.speech_code_gaps(enc["speech_encoder"], dims["speech_encoder"], clip, codes[:-1]) is None


def served_rows(model, monkeypatch, run):
    """The (prompt, prefill_len, trailing, trailing_len) that the program's
    session assembles for ``run(model)``."""
    seen = []
    finish = prefill_module._finish

    def keep(talker_params, tcfg, scfg, rows, *args):
        seen.append(rows)
        return finish(talker_params, tcfg, scfg, rows, *args)

    monkeypatch.setattr(prefill_module, "_finish", keep)
    run(model)
    (rows,) = seen
    return rows


def assert_rows(got, want_prompt, want_trailing, talker, frames=12):
    prompt, prefill_len, trailing, trailing_len = got
    assert prefill_len == want_prompt.shape[0]
    assert float((prompt[0, :prefill_len] - want_prompt).abs().max()) < 1e-6
    want = ref.text_additions(talker, want_trailing, frames)
    pad = ref.embed_text(talker, torch.tensor([ref.TTS_PAD]))
    served = torch.stack([trailing[min(i, trailing.shape[0] - 1)] if i < trailing_len else pad[0]
                          for i in range(frames)])
    assert float((served - want).abs().max()) < 1e-6


TEXT = "the voice of a reader carries each line"


@pytest.mark.parametrize("layout", ["xvector", "icl", "icl_sequential"])
def test_clone_prompt_rows_match_reference(base, monkeypatch, layout):
    _, (talker, cp, _), _, model, voices = base
    icl = layout != "xvector"
    voice = voices[1]
    prompt = model.create_voice_clone_prompt(program.q.AudioBuffer(voice.samples, traffic.SAMPLE_RATE),
                                             voice.ref_text if icl else None)
    opts = program.q.SynthesisOptions(max_length=12, icl_sequential=layout == "icl_sequential")
    got = served_rows(model, monkeypatch, lambda m: m.synthesize_voice_clone_streaming(TEXT, prompt, "english", opts))
    text_ids, xvector = traffic.WordTokenizer().encode(TEXT), torch.from_numpy(prompt.speaker_embedding)
    lang = traffic.LANGUAGES["english"]
    if icl:
        codes = torch.from_numpy(np.asarray(prompt.ref_codes, np.int64))
        want, trailing = ref.icl_prompt(talker, cp, text_ids, voice.ref_text_ids, xvector, codes, lang,
                                        layout == "icl_sequential")
    else:
        want, trailing = ref.xvector_prompt(talker, text_ids, xvector, lang), ref.trailing_text(text_ids)
    assert_rows(got, want, trailing, talker)


def test_icl_overlay_leaves_long_text_for_the_frames(base, monkeypatch):
    """A text longer than the reference's codec rows: the rest trails."""
    _, (talker, cp, _), _, model, voices = base
    voice = voices[0]
    prompt = model.create_voice_clone_prompt(program.q.AudioBuffer(voice.samples, traffic.SAMPLE_RATE),
                                             voice.ref_text)
    text = " ".join(traffic.WORDS[: len(prompt.ref_codes) + 6])
    opts = program.q.SynthesisOptions(max_length=12)
    got = served_rows(model, monkeypatch, lambda m: m.synthesize_voice_clone_streaming(text, prompt, "english", opts))
    want, trailing = ref.icl_prompt(talker, cp, traffic.WordTokenizer().encode(text), voice.ref_text_ids,
                                    torch.from_numpy(prompt.speaker_embedding),
                                    torch.from_numpy(np.asarray(prompt.ref_codes, np.int64)),
                                    traffic.LANGUAGES["english"], False)
    assert len(trailing) > 1 and trailing[-1] == ref.TTS_EOS
    assert_rows(got, want, trailing, talker)


def test_design_prompt_rows_match_reference(base, monkeypatch):
    _, (talker, _, _), _, model, _ = base
    instruct = "a warm low voice that reads slowly"
    opts = program.q.SynthesisOptions(max_length=12)
    got = served_rows(model, monkeypatch,
                      lambda m: m.synthesize_voice_design_streaming(TEXT, instruct, "english", opts))
    text_ids = traffic.WordTokenizer().encode(TEXT)
    want = ref.design_prompt(talker, text_ids, traffic.instruct_ids(instruct), traffic.LANGUAGES["english"])
    assert_rows(got, want, ref.trailing_text(text_ids), talker)


def test_repetition_penalty_rule_matches_program():
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((7, 3072), generator=gen)
    semantic = torch.tensor([5, 9, 5, 1200, 9, 7, 3])
    want = ref.penalised(logits, semantic, 1.5)
    for i in range(7):
        mask = torch.zeros(3072)
        mask[semantic[:i]] = 1.0
        got = sampling_module.apply_repetition_penalty(logits[i], mask, 1.5)
        assert torch.allclose(got, want[i], rtol=1e-6, atol=0)
    assert ref.penalised(logits, semantic, 1.0) is logits
    assert ref.served_penalty(1.0, icl=True) == 1.5 and ref.served_penalty(1.0, icl=False) == 1.0


@pytest.mark.parametrize("model_type", ["custom_voice", "base", "voice_design"])
def test_model_type_comes_from_the_file(model_type):
    config = dict(TINY_BASE_CONFIG if model_type == "base" else TINY_CONFIG, tts_model_type=model_type)
    cfg = program.model_config(spec.dims(config))
    assert cfg.model_type.value == model_type
    assert (cfg.speaker_encoder is not None) == (model_type == "base")
    with pytest.raises(ValueError):
        spec.dims(dict(TINY_CONFIG, tts_model_type="clone"))


def test_mix_refuses_icl_frames_over_the_cap():
    mix = dict(TINY_BASE_MIXES["tiny-icl-stream"], frames=[60, 90], text_tokens=[3, 8])
    with pytest.raises(ValueError, match="cap"):
        traffic.Plan(mix, SEED)
    traffic.Plan(dict(mix, text_tokens=[12, 15]), SEED)  # 6 x 12 = 72 frames and more
    with pytest.raises(ValueError):
        traffic.Plan(dict(mix, voices=0), SEED)


def test_voices_are_speech_like_and_every_greedy_request_meets_each():
    mix = dict(TINY_BASE_MIXES["tiny-icl-stream"], voices=3, ref_seconds=[3, 10], greedy_every=3)
    a, b = traffic.voices(mix, SEED), traffic.voices(mix, SEED)
    assert [v.ref_text for v in a] == [v.ref_text for v in b]
    assert all(np.array_equal(x.samples, y.samples) for x, y in zip(a, b))
    assert sorted(round(len(v.samples) / traffic.SAMPLE_RATE, 3) for v in a) == [4.167, 6.5, 8.833]
    for v in a:
        rms = float(np.sqrt(np.mean(v.samples.astype(np.float64) ** 2)))
        assert abs(rms - 0.08) < 1e-3 and float(np.abs(v.samples).max()) < 1.0
    plan = traffic.Plan(mix, SEED)
    greedy = [r.voice for r in (plan.next() for _ in range(18)) if r.greedy]
    assert sorted(set(greedy)) == [0, 1, 2]


def test_clone_counts_grow_with_the_prompt():
    d = spec.dims(TINY_BASE_CONFIG)
    preset = roofline.request_flops(d, 40, 8)
    icl = roofline.request_flops(d, 40, 8, prompt_rows=9 + 51, text_rows=9 + 14 + 1, prefix_frames=50)
    assert icl > preset
    one, two = roofline.encoder_flops(d, 24000, icl=True), roofline.encoder_flops(d, 48000, icl=True)
    assert roofline.encoder_flops(d, 24000, icl=False) < one and 1.8 < two / one < 2.2


# ---------------------------------------------------------------------------
# Pins: the existing cells draw, plan and count as before
# ---------------------------------------------------------------------------


def tree_hash(tree) -> str:
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is None:
            h.update(b"none")
        else:
            h.update(str(tuple(x.shape)).encode() + str(x.dtype).encode())
            h.update(x.float().contiguous().numpy().tobytes())

    walk(tree)
    return h.hexdigest()[:16]


@pytest.mark.parametrize("dtype,pinned", [("float32", "e151ba1a87a96bd0"), ("bfloat16", "ceb4455ca3d2edeb")])
def test_three_trees_are_pinned(dtype, pinned):
    """The tiny trees as drawn before the encoders came, and the same with a
    Base configuration's encoders declared."""
    for config in (TINY_CONFIG, TINY_BASE_CONFIG):
        assert tree_hash(weights.draw(spec.dims(dict(config, dtype=dtype)), 2**31 + 11, CPU)) == pinned


@pytest.mark.parametrize("size,count,pinned", [("1.7b", 74, "54803b3124d03725"), ("0.6b", 73, "b0cc05b3396757bc")])
def test_published_draws_are_pinned(monkeypatch, size, count, pinned):
    """Every draw's shape, type and scale at the published widths, in order
    (recorded, not made)."""
    d = spec.dims(json.loads((BENCH_DIR / "configs" / f"qwen3-tts-12hz-{size}-customvoice.json").read_text()))
    calls = []

    def record(gen, shape, dtype, scale=0.02):
        calls.append((tuple(shape), str(dtype), scale))
        return torch.empty(0)

    monkeypatch.setattr(weights, "_draw", record)
    monkeypatch.setattr(weights, "_ones", lambda shape, dtype, dev: torch.empty(0))
    monkeypatch.setattr(weights, "_zeros", lambda shape, dtype, dev: torch.empty(0))
    monkeypatch.setattr(weights.torch, "full", lambda *a, **k: torch.empty(0))
    weights.draw(d, 5, CPU)
    assert weights.draw_encoders(d, 5, CPU) == {}
    assert len(calls) == count and hashlib.sha256(repr(calls).encode()).hexdigest()[:16] == pinned


FIELDS = ("index", "frames", "text", "speaker", "language", "greedy", "seed")
PLANS = {
    "utterances-25-125": ("572c050bf739c8c5", "87fce4df50df84f9", "214d7349b9c703f5", "8422ccd80ec62d88"),
    "stream-16-64": ("da163a2313896798", "c22cbcbdcdededfc", "378bf82644719fb7", "98647e84980c471f"),
    "longform-1000-2000": ("88646c0d19e78499", "49b20e2d89fe1702", "7d09f1e291a56e76", "8929921c79a7edae"),
}


def requests_hash(reqs) -> str:
    return hashlib.sha256(repr([tuple(getattr(r, f) for f in FIELDS) for r in reqs]).encode()).hexdigest()[:16]


@pytest.mark.parametrize("mix_name", sorted(PLANS))
def test_existing_plans_are_pinned(mix_name):
    mix = json.loads((BENCH_DIR / "traffic" / f"{mix_name}.json").read_text())
    for seed, pinned in zip((7, 2**31 + 5, 3260000307), PLANS[mix_name]):
        plan = traffic.Plan(mix, seed)
        reqs = [plan.next() for _ in range(40)]
        assert requests_hash(reqs) == pinned
        assert all(r.prompt == "preset" and r.voice is None and r.instruct is None for r in reqs)
    assert requests_hash(traffic.warmup(mix, 9)) == PLANS[mix_name][3]
    assert traffic.voices(mix, 9) == []


@pytest.mark.parametrize("size,pinned", [
    ("1.7b", [287153270784, 695707729920, 1335324438528, 21469254156288]),
    ("0.6b", [219362832384, 549406212096, 1066274516992, 17427752845312]),
])
def test_preset_request_flops_are_pinned(size, pinned):
    d = spec.dims(json.loads((BENCH_DIR / "configs" / f"qwen3-tts-12hz-{size}-customvoice.json").read_text()))
    got = [roofline.request_flops(d, f, t) for f, t in ((25, 6), (64, 24), (125, 40), (2000, 400))]
    assert got == pinned
    assert roofline.request_flops(d, 64, 24) == roofline.request_flops(d, 64, 24, prompt_rows=10, text_rows=35)
