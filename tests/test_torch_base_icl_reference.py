"""The port's in-context voice clone against the benchmark's plain reference (CPU, float32).

The benchmark's ``qwen3-tts-12hz-1.7b-base`` configuration streams one-shot
in-context (ICL) clones on the card; this holds the same path of the port to
``bench_port/reference`` (``qwen3_tts.py`` and ``encoders.py``, plain PyTorch
that imports neither the port nor JAX) at a tiny Base size, on weights and
encoders drawn from a seed by ``bench_port/harness/weights.py`` and built
into ``Qwen3TTS`` as the benchmark builds them. One greedy clone stream is
served from a 1.1 s clip and its transcript, and these readings are taken,
each the largest difference over the reference's largest value:

* ``xvector``: the served x-vector against the reference ECAPA-TDNN's;
* ``ref_codes``: the served reference codes against the reference speech
  encoder's, code for code (the share that differ);
* ``talker``: the talker's codec logits at every frame, as the frame loop
  handed them to the penalties, against the reference talker run once over
  the ICL prompt (built from the served x-vector and codes) and the served
  frames, teacher-forced;
* ``code_predictor``: the 15 acoustic codes' logits of every frame against
  the reference code predictor's on the served codes;
* ``audio``: the stream's samples against the reference vocoder's decode of
  [reference codes || frames] with the reference's samples cut.

Every product runs in float32 on both sides, so the readings are rounding:
the port sums in other orders (its fused projections, its cached attention,
its streaming vocoder in pieces). The tolerances (``TOLERANCE``) sit about
ten times above what the readings give and far below what the perturbed
cases give.
"""

import numpy as np
import pytest
import torch

from bench_port.harness import program, spec, traffic, weights
from bench_port.reference import encoders as ref_enc
from bench_port.reference import qwen3_tts as ref
from qwen3_tts_tpu_torch import pipeline
from qwen3_tts_tpu_torch.audio.io import AudioBuffer
from qwen3_tts_tpu_torch.models.speaker import SpeakerEncoder
from qwen3_tts_tpu_torch.ops import fused_layer, sampling

SEED = 2**31 + 28
FRAMES = 18
TEXT = "the voice of a reader carries each line across the room"
# A tiny Base model: talker, code predictor and vocoder as the benchmark's
# tiny test cells, and both audio encoders at tiny widths (the speech
# encoder's codebook no larger than the code predictor's vocabulary: the
# reference codes index its embeddings).
CONFIG = {
    "dtype": "float32", "tts_model_type": "base", "tts_model_size": "tiny",
    "talker_config": {
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
        "rope_scaling": {"mrope_section": [4, 2, 2]}, "max_position_embeddings": 32768, "vocab_size": 3072,
        "text_vocab_size": 151936, "text_hidden_size": 32,
        "code_predictor_config": {
            "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 8, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
            "vocab_size": 2048, "num_code_groups": 16}},
    "vocoder": {
        "codebook_dim": 16, "latent_dim": 32, "hidden_size": 16, "num_layers": 1, "num_heads": 2, "head_dim": 8,
        "intermediate_size": 32, "num_quantizers": 16, "codebook_size": 2048, "codebook_embed_dim": 8,
        "upsampling_ratios": [2, 2], "decoder_dim": 48, "upsample_rates": [8, 5, 4, 3], "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "final_kernel": 7},
    "speaker_encoder_config": {
        "mel_dim": 32, "enc_dim": 64, "enc_channels": [32, 32, 32, 32, 96], "enc_kernel_sizes": [5, 3, 3, 3, 1],
        "enc_dilations": [1, 2, 3, 4, 1], "enc_attention_channels": 16, "enc_res2net_scale": 4,
        "enc_se_channels": 8, "sample_rate": 24000},
    "encoder_config": {
        "sampling_rate": 24000, "frame_rate": 12.5, "num_filters": 8, "upsampling_ratios": [8, 6, 5, 4],
        "kernel_size": 7, "last_kernel_size": 3, "residual_kernel_size": 3, "compress": 2, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "head_dim": 16, "intermediate_size": 64, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 250, "layer_scale_initial_scale": 0.01, "codebook_size": 64,
        "codebook_dim": 16, "num_quantizers": 16, "num_semantic_quantizers": 1},
}
MIX = {"prompt": "icl", "voices": 1, "ref_seconds": [1.1, 1.1], "ref_text_tokens": [5, 5]}
# Each reading's tolerance, about ten times the float32 rounding it reads
# here (4.5e-7, 3.4e-7, 8.7e-7, 5.1e-7 in turn on this seed): the x-vector
# passes a clip through the ECAPA-TDNN's convolutions and pooling, the logits
# come out of two layers and a head, the audio out of the vocoder's
# convolutions, whose pieces and chunks sum in another order than one decode.
# The reference codes are exact: the nearest codeword at every stage.
TOLERANCE = {"xvector": 5e-6, "ref_codes": 0.0, "talker": 5e-6, "code_predictor": 1e-5, "audio": 5e-6}


@pytest.fixture(scope="module")
def clone():
    """(dims, the three trees, the encoders' trees, the port's model, the voice)."""
    torch.set_num_threads(2)
    dims = spec.dims(CONFIG)
    cpu = torch.device("cpu")
    trees, enc = weights.draw(dims, SEED, cpu), weights.draw_encoders(dims, SEED, cpu)
    model = program.build(dims, trees, traffic.WordTokenizer(), encoders=enc)
    (voice,) = traffic.voices(MIX, SEED)
    return dims, trees, enc, model, voice


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30))


def served(model, voice, monkeypatch) -> dict:
    """One greedy ICL clone stream: its prompt, frames, samples, and the
    logits the talker and the code predictor computed on the way."""
    talker_logits, cp_logits = [], []
    penalties = sampling.apply_generation_penalties

    def keep_talker(logits, *args):
        talker_logits.append(logits.detach().reshape(-1).clone())
        return penalties(logits, *args)

    frame = fused_layer.cp_frame_layers_batch
    vocab = model.config.code_predictor.vocab_size

    def keep_cp(params, cfg, hidden, semantic, matmul):
        def mm(x, w, *args, **kwargs):
            out = matmul(x, w, *args, **kwargs)
            if out.shape[-1] == vocab:  # a head's product: one acoustic code's logits
                cp_logits.append(out.detach().reshape(-1).clone())
            return out

        return frame(params, cfg, hidden, semantic, mm)

    prompt = model.create_voice_clone_prompt(AudioBuffer(voice.samples, traffic.SAMPLE_RATE), voice.ref_text)
    opts = pipeline.SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=3, temperature=0.0,
                                     repetition_penalty=1.0, streaming_lookahead=1, chunk_frames=10,
                                     first_chunk_frames=4)
    with monkeypatch.context() as m:
        m.setattr(sampling, "apply_generation_penalties", keep_talker)
        m.setattr(fused_layer, "cp_frame_layers_batch", keep_cp)
        session = model.synthesize_voice_clone_streaming(TEXT, prompt, "english", opts)
        audio = np.concatenate([c.samples for c in session])
    codes = session.state.frames[:FRAMES].long()
    acoustic = codes.shape[1] - 1
    return {"prompt": prompt, "codes": codes, "audio": torch.from_numpy(audio),
            "talker": torch.stack(talker_logits[:FRAMES]),
            "code_predictor": torch.stack(cp_logits[: FRAMES * acoustic]).reshape(FRAMES, acoustic, -1)}


def readings(dims, trees, enc, voice, got) -> dict:
    """Each reading of ``got`` (``served``) against the reference."""
    talker, cp, voc = trees
    clip = torch.from_numpy(voice.samples)
    prompt, codes = got["prompt"], got["codes"]
    prefix = torch.from_numpy(np.asarray(prompt.ref_codes, np.int64))
    want_codes = ref_enc.speech_codes(enc["speech_encoder"], dims["speech_encoder"], clip)
    out = {"xvector": _err(torch.from_numpy(prompt.speaker_embedding),
                           ref_enc.speaker_xvector(enc["speaker_encoder"], dims["speaker_encoder"], clip)),
           "ref_codes": 1.0 if prefix.shape != want_codes.shape else float((prefix != want_codes).float().mean())}
    rows, trailing = ref.icl_prompt(talker, cp, traffic.WordTokenizer().encode(TEXT), voice.ref_text_ids,
                                    torch.from_numpy(prompt.speaker_embedding), prefix,
                                    traffic.LANGUAGES["english"], False)
    hidden, logits = ref.talker_logits(talker, dims["talker"], torch.cat(
        [rows, ref.step_inputs(talker, cp, trailing, codes[:-1])]))
    at = rows.shape[0] - 1  # row at + i predicts frame i's semantic code
    out["talker"] = _err(got["talker"], logits[at: at + FRAMES])
    want_cp = ref.code_predictor_logits(cp, dims["code_predictor"], hidden[at: at + FRAMES],
                                        ref.embed_codec(talker, codes[:, 0]), codes[:, 1:])
    out["code_predictor"] = _err(got["code_predictor"], want_cp)
    want_audio = ref.vocoder_decode(voc, dims["vocoder"], torch.cat([prefix, codes]))
    out["audio"] = _err(got["audio"], want_audio[len(prefix) * ref.SAMPLES_PER_FRAME:])
    return out


@pytest.fixture
def strict(monkeypatch):
    """Float32 products at full precision on every side (TF32 off)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def test_icl_clone_matches_reference(clone, monkeypatch, strict):
    dims, trees, enc, model, voice = clone
    got = served(model, voice, monkeypatch)
    assert len(got["prompt"].ref_codes) == 14 and len(got["audio"]) == FRAMES * ref.SAMPLES_PER_FRAME
    found = readings(dims, trees, enc, voice, got)
    assert all(found[k] <= TOLERANCE[k] for k in TOLERANCE), found


def _bf16_speaker_encoder(model, monkeypatch):
    enc = model.speaker_encoder

    def rounded(tree):
        if isinstance(tree, dict):
            return {k: rounded(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rounded(v) for v in tree)
        return tree.to(torch.bfloat16).float() if isinstance(tree, torch.Tensor) else tree

    monkeypatch.setattr(model, "speaker_encoder", SpeakerEncoder(rounded(enc.params), enc.cfg))


def _prefix_dropped(model, monkeypatch):
    monkeypatch.setattr(pipeline.StreamingSession, "_feed_prefix", lambda self, prefix, chunk: None)


@pytest.mark.parametrize("perturb,fails", [(_bf16_speaker_encoder, "xvector"), (_prefix_dropped, "audio")])
def test_perturbed_clone_fails_by_its_reading(clone, monkeypatch, strict, perturb, fails):
    dims, trees, enc, model, voice = clone
    with monkeypatch.context() as m:
        perturb(model, m)
        got = served(model, voice, m)
    found = readings(dims, trees, enc, voice, got)
    assert found[fails] > 10 * TOLERANCE[fails], found
    assert all(found[k] <= TOLERANCE[k] for k in TOLERANCE if k != fails), found
