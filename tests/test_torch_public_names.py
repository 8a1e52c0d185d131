"""Public names of the JAX package that the port lacked, against the JAX package (CPU).

* ``Qwen3TTS.create_voice_clone_prompt(..., pad_to_seconds=)``: the audio,
  resampled to 24 kHz first, is zero-padded to a whole number of
  ``pad_to_seconds`` units (at least one) before both encoders. A 2.6 s
  reference at 24 kHz and at 16 kHz with ``pad_to_seconds=1.0`` (3 s
  after padding; a 3 s reference would be a whole number of units, and
  the padding a no-op) gives the JAX package's x-vector within 1e-5 of
  max|x| and its ICL codes equal; ``pad_to_seconds=None`` is the unpadded
  prompt.
* ``generation.prefill.prefill_custom_voice``: the JAX alias's state on
  the tiny model.
* ``utils.device.auto_device()``: raises without a card (no CPU fallback);
  with ``torch.cuda`` reporting one card, it is ``cuda:0``.
* The multi-GPU serving names: ``parallel.sharding.make_mesh`` (a (dp, tp)
  mesh of the JAX package's shape), ``Qwen3TTS.shard`` (returns the model),
  ``Qwen3TTS.mesh`` (None until sharded, then the mesh) and
  ``from_pretrained``'s ``mesh`` keyword, each as the JAX package has it.
* The package's ``__all__`` and ``models.codec.__all__``: the JAX package's
  names as sets, each name bound; ``hub``: its constants equal, and
  ``download`` asks ``huggingface_hub.hf_hub_download`` for the JAX
  module's files in the same order and directories (the function
  replaced in both, so nothing reaches the network).
"""

import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio
from qwen3_tts_tpu.generation import prefill as jprefill
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import rng as jrng
from qwen3_tts_tpu.ops import sampling as jsampling
from qwen3_tts_tpu_torch import encoder_fixture
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio
from qwen3_tts_tpu_torch.audio.resample import resample_to_24k
from qwen3_tts_tpu_torch.generation import prefill as tprefill
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import sampling as tsampling
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS
from qwen3_tts_tpu_torch.utils import device as tdevice
from test_pipeline import TINY_TALKER
from test_torch_voice_clone import REF_TEXT, build_models

torch.set_num_threads(1)

SECONDS = 2.6


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.mark.parametrize("rate", [24000, 16000])
def test_pad_to_seconds_matches_jax(models, rate):
    jm, tm = models
    audio = encoder_fixture.reference_audio(rate, seed=5, seconds=SECONDS)
    jp = jm.create_voice_clone_prompt(JAudio(audio, rate), REF_TEXT, pad_to_seconds=1.0)
    tp = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT, pad_to_seconds=1.0)
    scale = np.abs(jp.speaker_embedding).max()
    np.testing.assert_allclose(tp.speaker_embedding, jp.speaker_embedding, rtol=0, atol=1e-5 * scale)
    assert tp.ref_codes.shape == jp.ref_codes.shape
    np.testing.assert_array_equal(tp.ref_codes, jp.ref_codes)
    assert tp.ref_text_ids == jp.ref_text_ids

    plain = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT)
    unpadded = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT, pad_to_seconds=None)
    np.testing.assert_array_equal(unpadded.speaker_embedding, plain.speaker_embedding)
    np.testing.assert_array_equal(unpadded.ref_codes, plain.ref_codes)
    # The padded prompt is that of the 24 kHz audio zero-padded to 3 s by hand.
    at24 = resample_to_24k(TAudio(audio, rate)).samples if rate != 24000 else audio
    by_hand = np.zeros(3 * 24000, np.float32)
    by_hand[:len(at24)] = at24
    want = tm.create_voice_clone_prompt(TAudio(by_hand, 24000), REF_TEXT)
    np.testing.assert_array_equal(tp.speaker_embedding, want.speaker_embedding)
    np.testing.assert_array_equal(tp.ref_codes, want.ref_codes)
    assert plain.ref_codes.shape[0] < tp.ref_codes.shape[0]
    assert np.abs(plain.speaker_embedding - tp.speaker_embedding).max() > 0


def test_prefill_custom_voice_matches_jax(models):
    jm, tm = models
    max_new, rows = 8, 32
    ids = np.array([5, 9, 3, 7, 0, 0, 0, 0], np.int64)
    uniforms = jrng.pcg_uniform_sequence(42, max_new + 1)
    stack = tm.config.talker.layer_stack()
    jstate, jtrail, jlen, jpad = jprefill.prefill_custom_voice(
        jm.talker_params, jm.config.talker, jsampling.SamplingConfig(), jnp.asarray(ids, jnp.int32), jnp.int32(4),
        jnp.int32(3061), jnp.int32(2050), jnn.init_kv_cache(jm.config.talker.layer_stack(), 1, rows, jnp.float32),
        jnp.asarray(uniforms), max_new)
    tstate, ttrail, tlen, tpad = tprefill.prefill_custom_voice(
        tm.talker_params, tm.config.talker, tsampling.SamplingConfig(), torch.from_numpy(ids), 4, 3061, 2050,
        tnn.init_kv_cache(stack, 1, rows, torch.float32, torch.device("cpu")), torch.from_numpy(uniforms), max_new)
    assert int(tstate.token) == int(jstate.token)
    assert tstate.pos == int(jstate.pos) and tstate.frame_idx == int(jstate.frame_idx) == 0
    assert tlen == int(jlen)
    for got, want in ((tstate.last_hidden, jstate.last_hidden), (tstate.cache.k, jstate.cache.k),
                      (tstate.cache.v, jstate.cache.v), (tstate.penalty_mask, jstate.penalty_mask),
                      (ttrail, jtrail), (tpad, jpad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert tstate.last_hidden.shape == (1, 1, TINY_TALKER.hidden_size)


def test_auto_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.auto_device()
    assert tdevice.parse_device("cpu") == torch.device("cpu")


def test_auto_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.auto_device() == torch.device("cuda", 0)
    assert tdevice.parse_device("auto") == torch.device("cuda", 0)


def test_make_mesh_is_public():
    from qwen3_tts_tpu.parallel import sharding as jsharding
    from qwen3_tts_tpu_torch.parallel import sharding as tsharding

    assert tsharding.make_mesh(["cpu"] * 4, tp=2).shape == dict(jsharding.make_mesh(jax.devices()[:4], tp=2).shape)


def test_shard_returns_the_model(models):
    from qwen3_tts_tpu_torch.parallel import sharding as tsharding

    _, tm = models
    model = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                     vocoder_config=tm.vocoder_config)
    mesh = tsharding.make_mesh(["cpu"] * 2, tp=2)
    assert model.shard(mesh) is model and model.mesh is mesh


def test_mesh_attribute(models):
    jm, tm = models
    assert jm.mesh is None and tm.mesh is None


def test_from_pretrained_takes_a_mesh():
    want = inspect.signature(JP.Qwen3TTS.from_pretrained).parameters["mesh"]
    got = inspect.signature(Qwen3TTS.from_pretrained).parameters["mesh"]
    assert got.default is want.default is None and got.kind == want.kind


def test_package_all_matches_jax():
    import qwen3_tts_tpu
    import qwen3_tts_tpu_torch

    assert set(qwen3_tts_tpu_torch.__all__) == set(qwen3_tts_tpu.__all__)
    assert all(hasattr(qwen3_tts_tpu_torch, name) for name in qwen3_tts_tpu_torch.__all__)
    assert qwen3_tts_tpu_torch.CODEC_EOS_TOKEN_ID == qwen3_tts_tpu.CODEC_EOS_TOKEN_ID
    assert qwen3_tts_tpu_torch.SAMPLES_PER_FRAME == qwen3_tts_tpu.SAMPLES_PER_FRAME


def test_codec_all_matches_jax():
    from qwen3_tts_tpu.models import codec as jcodec
    from qwen3_tts_tpu_torch.models import codec as tcodec

    assert set(tcodec.__all__) == set(jcodec.__all__)
    assert all(hasattr(tcodec, name) for name in tcodec.__all__)


def test_hub_constants_match_jax():
    from qwen3_tts_tpu import hub as jhub
    from qwen3_tts_tpu_torch import hub as thub

    assert thub.MODEL_IDS == jhub.MODEL_IDS
    assert (thub.SPEECH_TOKENIZER_ID, thub.TEXT_TOKENIZER_ID) == (jhub.SPEECH_TOKENIZER_ID, jhub.TEXT_TOKENIZER_ID)
    assert inspect.signature(thub.download) == inspect.signature(jhub.download)


@pytest.mark.parametrize("tokenizer_json", [True, False], ids=["tokenizer_json", "vocab_merges"])
def test_hub_download_asks_for_the_jax_files(tmp_path, monkeypatch, tokenizer_json):
    """Both ``download``s against a stand-in ``hf_hub_download`` (the module
    is imported inside the function, so the stand-in is what it finds):
    the same (repo, file, revision, directory) requests, the same returned
    directory; without ``tokenizer.json`` both fall back to vocab + merges."""
    huggingface_hub = pytest.importorskip("huggingface_hub")
    from qwen3_tts_tpu import hub as jhub
    from qwen3_tts_tpu_torch import hub as thub

    def run(download, root):
        calls = []

        def fake(repo, fname, revision=None, local_dir=None):
            calls.append((repo, fname, revision, str(Path(local_dir).relative_to(root))))
            if fname == "tokenizer.json" and not tokenizer_json:
                raise FileNotFoundError(fname)
            return str(Path(local_dir) / fname)

        monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake)
        out = download("1.7b-customvoice", root, revision="r1")
        return calls, str(out.relative_to(root))

    want = run(jhub.download, tmp_path / "jax")
    got = run(thub.download, tmp_path / "port")
    assert got == want
    assert got[1] == "Qwen3-TTS-12Hz-1.7B-CustomVoice"
    assert [c[1] for c in got[0]][-1] == ("tokenizer.json" if tokenizer_json else "tokenizer_config.json")
