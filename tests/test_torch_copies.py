"""The PyTorch port's framework-free copies equal their JAX-package originals.

Token tables, model configs, the PCG uniform stream, bucketing, WAV I/O,
mel spectrograms, resampling and the native-library bindings are copied
into ``qwen3_tts_tpu_torch``; each copy must give the same values (or
bytes) as the module it was copied from. Also checks that the port never
loads JAX.
"""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from enum import Enum
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import native as jnative
from qwen3_tts_tpu.audio import io as jio
from qwen3_tts_tpu.audio import mel as jmel
from qwen3_tts_tpu.audio import resample as jresample
from qwen3_tts_tpu.models import config as jconfig
from qwen3_tts_tpu.models import tokens as jtokens
from qwen3_tts_tpu.ops import rng as jrng
from qwen3_tts_tpu.utils import bucketing as jbucketing
from qwen3_tts_tpu_torch import native as tnative
from qwen3_tts_tpu_torch.audio import io as tio
from qwen3_tts_tpu_torch.audio import mel as tmel
from qwen3_tts_tpu_torch.audio import resample as tresample
from qwen3_tts_tpu_torch.models import config as tconfig
from qwen3_tts_tpu_torch.models import tokens as ttokens
from qwen3_tts_tpu_torch.ops import rng as trng
from qwen3_tts_tpu_torch.utils import bucketing as tbucketing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _plain(obj):
    """Dataclasses/enums -> JSON-comparable plain values."""
    return json.loads(
        json.dumps(dataclasses.asdict(obj), default=lambda o: o.value if isinstance(o, Enum) else str(o))
    )


def test_token_tables_equal():
    names = [n for n in dir(jtokens) if n.isupper()]
    assert names == [n for n in dir(ttokens) if n.isupper()]
    for name in names:
        a, b = getattr(jtokens, name), getattr(ttokens, name)
        if name == "SPEAKERS":
            a = {k: dataclasses.astuple(v) for k, v in a.items()}
            b = {k: dataclasses.astuple(v) for k, v in b.items()}
        assert a == b, name
    for lang in list(jtokens.LANGUAGES) + ["en", " ZH ", "ja"]:
        assert ttokens.language_token_id(lang) == jtokens.language_token_id(lang)
    for spk in list(jtokens.SPEAKERS) + ["UncleFu", "onoanna"]:
        assert dataclasses.astuple(ttokens.speaker_info(spk)) == dataclasses.astuple(jtokens.speaker_info(spk))
    with pytest.raises(ValueError):
        ttokens.language_token_id("klingon")


@pytest.mark.parametrize("size", ["0.6B", "1.7B"])
@pytest.mark.parametrize("variant", ["base", "custom_voice", "voice_design"])
def test_config_for_variant_equal(size, variant):
    j = jconfig.config_for_variant(size, variant)
    t = tconfig.config_for_variant(size, variant)
    assert _plain(t) == _plain(j)
    assert (t.label, t.code_predictor.needs_projection, t.code_predictor.num_acoustic) == (
        j.label, j.code_predictor.needs_projection, j.code_predictor.num_acoustic,
    )
    for part in ("talker", "code_predictor"):
        jl = _plain(getattr(j, part).layer_stack())
        tl = _plain(getattr(t, part).layer_stack())
        assert tl == {k: jl[k] for k in tl}


def test_parse_config_json_equal(tmp_path):
    cfg = {
        "tts_model_type": "custom_voice",
        "tts_model_size": "1b7",
        "talker_config": {
            "hidden_size": 2048,
            "intermediate_size": 6144,
            "rope_scaling": {"mrope_section": [24, 20, 20]},
            "code_predictor_config": {"hidden_size": 1024, "num_code_groups": 16},
        },
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    assert _plain(tconfig.parse_config_json(path)) == _plain(jconfig.parse_config_json(path))


@pytest.mark.parametrize("seed", [0, 42, 12345, 2**63 + 7])
def test_pcg_stream_equal(seed):
    np.testing.assert_array_equal(trng.pcg_uniform_sequence(seed, 257), jrng.pcg_uniform_sequence(seed, 257))


def test_next_bucket_equal():
    for n in [0, 1, 31, 32, 33, 100, 2047, 2048, 5000]:
        assert tbucketing.next_bucket(n) == jbucketing.next_bucket(n)
        assert tbucketing.next_bucket(n, 64) == jbucketing.next_bucket(n, 64)
        buckets = (64, 128, 256, 512, 1024, 2048)
        assert tbucketing.next_bucket(n, buckets=buckets) == jbucketing.next_bucket(n, buckets=buckets)


def test_wav_bytes_equal(tmp_path):
    rs = np.random.RandomState(0)
    samples = (rs.randn(4801) * 0.5).astype(np.float32)  # some clip past +-1
    jio.save_wav(tmp_path / "j.wav", samples, 24000)
    tio.save_wav(tmp_path / "t.wav", samples, 24000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    a, b = tio.load_wav(tmp_path / "j.wav"), jio.load_wav(io.BytesIO((tmp_path / "j.wav").read_bytes()))
    np.testing.assert_array_equal(a.samples, b.samples)
    assert a.sample_rate == b.sample_rate == 24000
    ta, ja = tio.AudioBuffer(samples, 24000), jio.AudioBuffer(samples, 24000)
    ta.normalize_db(-3.0)
    ja.normalize_db(-3.0)
    np.testing.assert_array_equal(ta.samples, ja.samples)
    assert ta.duration == ja.duration


MEL_CONFIGS = {
    "default": {},
    "speaker-encoder": dataclasses.asdict(jmel.speaker_encoder_config()),
    "windowed": dict(n_mels=80, fmin=20.0, fmax=8000.0, win_length=300),
}


@pytest.mark.parametrize("n", [1, 300, 24000, 37123])
@pytest.mark.parametrize("config", sorted(MEL_CONFIGS))
def test_mel_equal(n, config):
    """Filterbank, STFT and the three spectrogram forms, bit for bit."""
    samples = (0.3 * np.random.RandomState(n).randn(n)).astype(np.float32)
    jm = jmel.MelSpectrogram(jmel.MelConfig(**MEL_CONFIGS[config]))
    tm = tmel.MelSpectrogram(tmel.MelConfig(**MEL_CONFIGS[config]))
    np.testing.assert_array_equal(tm.fb, jm.fb)
    np.testing.assert_array_equal(tmel.stft(samples, tm.cfg), jmel.stft(samples, jm.cfg))
    for form in ("compute", "compute_log", "compute_for_speaker_encoder"):
        np.testing.assert_array_equal(getattr(tm, form)(samples), getattr(jm, form)(samples))
    f = np.linspace(0, 12000, 97)
    np.testing.assert_array_equal(tmel.hz_to_mel(f), jmel.hz_to_mel(f))
    np.testing.assert_array_equal(tmel.mel_to_hz(f / 100), jmel.mel_to_hz(f / 100))
    np.testing.assert_array_equal(tmel.hann_window(400), jmel.hann_window(400))


def _reload_native(monkeypatch) -> None:
    """Both bindings load the library afresh, the JAX package's first (it
    builds the library if it is missing): a process whose first attempt met
    another worker's build in progress then sees the finished file."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)
        mod._load()


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("rate", [16000, 22050, 24000, 44100, 48000])
def test_resample_equal(rate, path, monkeypatch):
    """``resample_to_24k`` through the native library where it is built,
    and through the numpy fallback (the library switched off in both)."""
    if path == "numpy":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        _reload_native(monkeypatch)
    samples = np.sin(np.arange(rate // 3) * 0.05).astype(np.float32) * 0.7
    got = tresample.resample_to_24k(tio.AudioBuffer(samples, rate))
    want = jresample.resample_to_24k(jio.AudioBuffer(samples, rate))
    assert got.sample_rate == want.sample_rate == 24000
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(tresample.resample_array(samples, rate, 16000, 64),
                                  jresample.resample_array(samples, rate, 16000, 64))


def test_native_bindings_equal(tmp_path, monkeypatch):
    """Both packages load the same library (or, without a C++ toolchain,
    neither does) and their entry points give the same values and bytes."""
    assert tnative._LIB_PATH == jnative._LIB_PATH
    _reload_native(monkeypatch)
    assert tnative.available() == jnative.available()
    samples = (np.random.RandomState(2).rand(5000).astype(np.float32) - 0.5) * 1.5
    for seed in (0, 42, 2**63 + 5):
        a, b = tnative.pcg_uniforms(seed, 300), jnative.pcg_uniforms(seed, 300)
        assert (a is None) == (b is None) == (not jnative.available())
        if a is not None:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, trng.pcg_uniform_sequence(seed, 300))
    a, b = tnative.resample_sinc(samples, 48000, 24000), jnative.resample_sinc(samples, 48000, 24000)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
    wrote = tnative.wav_write_pcm16(str(tmp_path / "t.wav"), samples, 24000)
    assert wrote == jnative.wav_write_pcm16(str(tmp_path / "j.wav"), samples, 24000)
    if wrote:
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_port_imports_no_jax():
    """Importing every port module leaves jax and the JAX package unloaded."""
    code = (
        "import sys, pkgutil, importlib, qwen3_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'qwen3_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'qwen3_tts_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|qwen3_tts_tpu)\b", re.M)
    offenders = [
        str(p) for p in (REPO / "qwen3_tts_tpu_torch").rglob("*.py") if pattern.search(p.read_text())
    ]
    assert offenders == []
