"""The port's loading path against the JAX package's, on the CPU.

The checkpoint is the tiny HF-layout one of ``tests/test_checkpoint_loading.py``
(talker, code predictor, speaker encoder, vocoder and Mimi encoder at small
widths, with the exact HF names and orientations), written as
``scripts/make_synthetic_ckpt.py`` writes it (safetensors files from the
``safetensors`` package, a byte-level ``vocab.json`` + ``merges.txt``, the
vocoder and Mimi sidecars). Both packages load it with their own
``from_pretrained``:

* every tree equal bit for bit to the JAX package's trees (through
  ``from_numpy_tree`` / ``speaker_encoder_from_numpy`` /
  ``mimi_encoder_from_numpy``), in f32 and in bf16 (the bf16 comparison in
  torch: numpy has no bf16);
* the port's safetensors reader against the ``safetensors`` package on
  every dtype it maps, an empty and a 0-d tensor and ``__metadata__``, and
  the malformed files it must refuse;
* the sidecars (unknown keys refused), the weight-shape sniffing without
  config.json, the speech tokenizer in the parent directory, a missing or
  incomplete ``encoder.*`` set (no Mimi encoder; any other error raises),
  and ``ckpt_fixture.config_json`` through ``parse_config_json`` for every
  published variant;
* the slice as a whole in f32: ``synthesize_with_timing``, a streamed
  session, x-vector and ICL cloning and voice design, greedy and under
  seeded PCG sampling: token-exact frames, audio within atol 1e-5 and 1e-4
  of max|audio|.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import SafetensorError
from safetensors.torch import load_file, save_file

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio
from qwen3_tts_tpu.models import config as jconfig
from qwen3_tts_tpu.models.codec import encoder as jencoder
from qwen3_tts_tpu_torch import ckpt_fixture
from qwen3_tts_tpu_torch import pipeline as TP
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio
from qwen3_tts_tpu_torch.models import config as tconfig
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec.encoder import Encoder12Hz, MimiEncoderConfig
from qwen3_tts_tpu_torch.models.codec.vocoder import VocoderConfig
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions, VoiceClonePrompt
from scripts.make_synthetic_ckpt import write_ckpt

torch.set_num_threads(1)

TEXT = "Loaded from disk."
REF_TEXT = "Reference words."
INSTRUCT = "a calm, low voice"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_ckpt(tmp_path_factory.mktemp("ckpt"))


_MODELS = {}


def models(ckpt, dtype: str) -> tuple:
    """(JAX model, port model) from ``ckpt`` in ``dtype``, loaded once a module."""
    key = (str(ckpt), dtype)
    if key not in _MODELS:
        _MODELS[key] = (JP.Qwen3TTS.from_pretrained(ckpt, dtype=getattr(jnp, dtype)),
                        Qwen3TTS.from_pretrained(ckpt, dtype=getattr(torch, dtype), device="cpu"))
    return _MODELS[key]


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_equal(got, want, path="") -> None:
    """Same structure, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.shape, want.shape, got.dtype)
        assert got.is_contiguous(), path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trees_equal_jax(ckpt, dtype):
    jm, tm = models(ckpt, dtype)
    assert tm.config.label == jm.config.label == "0.6B Base"
    assert tm.compute_dtype == getattr(torch, dtype)
    assert_trees_equal(tm.talker_params, TW.from_numpy_tree(_numpy(jm.talker_params), "cpu"))
    # The port keeps the code predictor fused (q|k|v, gate|up) for the frame kernel.
    assert_trees_equal(tm.cp_params, TW.fuse_model_params(TW.from_numpy_tree(_numpy(jm.cp_params), "cpu")))
    assert_trees_equal(tm.vocoder_params, TW.from_numpy_tree(_numpy(jm.vocoder_params), "cpu"))
    assert_trees_equal(tm.speaker_encoder.params,
                       TW.speaker_encoder_from_numpy(_numpy(jm.speaker_encoder.params), "cpu"))
    assert_trees_equal(tm.speech_encoder.params,
                       TW.mimi_encoder_from_numpy(_numpy(jm.speech_encoder.params), "cpu"))
    assert asdict(tm.vocoder_config) == asdict(jm.vocoder_config)
    assert asdict(tm.speech_encoder.cfg) == asdict(jm.speech_encoder.cfg)
    assert asdict(tm.config) == asdict(jm.config)


def test_key_maps_on_the_raw_tensors(ckpt):
    """``from_pretrained``'s trees are the key maps of the raw file: the
    talker's as loaded (unfused on the CPU), the vocoder's f32."""
    _, tm = models(ckpt, "float32")
    raw = TW.load_safetensors(ckpt / "model.safetensors", "cpu")
    assert_trees_equal(tm.talker_params, TW.load_talker_params(raw, tm.config.talker, torch.float32))
    cp = TW.load_code_predictor_params(raw, tm.config.code_predictor, torch.float32)
    assert cp["mtp_proj"] is None  # the tiny checkpoint's code predictor is as wide as its talker
    assert_trees_equal(tm.cp_params, TW.fuse_model_params(cp))


# -- the safetensors reader ---------------------------------------------------

_DTYPES = ["bfloat16", "float16", "float32", "float64", "int8", "uint8", "int16", "int32", "int64", "bool"]


def _sample(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_reader_matches_safetensors(tmp_path, dtype):
    """Every dtype the reader maps, with an empty and a 0-d tensor and
    ``__metadata__``; files of the package and of ``ckpt_fixture``."""
    dt = getattr(torch, dtype)
    # "odd" first: in ckpt_fixture's file (written in this order) every
    # tensor after it lies at an offset its dtype does not divide.
    tensors = {"odd": _sample(torch.uint8, (3,), 5), "a": _sample(dt, (3, 5), 1), "empty": _sample(dt, (2, 0), 2),
               "scalar": _sample(dt, (), 3), "b": _sample(dt, (7,), 4)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = TW.load_safetensors(path, "cpu"), load_file(str(path))
    assert got.keys() == want.keys() == tensors.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    ours = tmp_path / "ours.safetensors"
    ckpt_fixture.write_safetensors(ours, tensors)
    back, again = load_file(str(ours)), TW.load_safetensors(ours, "cpu")
    for k in tensors:
        assert back[k].dtype == again[k].dtype == tensors[k].dtype, k
        assert torch.equal(back[k], tensors[k]) and torch.equal(again[k], tensors[k]), k


def _file(header: dict, data: bytes = b"", length: int | None = None, raw: bytes | None = None) -> bytes:
    blob = raw if raw is not None else json.dumps(header).encode()
    return (len(blob) if length is None else length).to_bytes(8, "little") + blob + data


_F32_8 = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
_MALFORMED = {
    # name: (file bytes, whether the safetensors package refuses it too)
    "unknown dtype": (_file({"x": {"dtype": "X9", "shape": [2], "data_offsets": [0, 8]}}, bytes(8)), True),
    "unmapped dtype": (_file({"x": {"dtype": "U16", "shape": [4], "data_offsets": [0, 8]}}, bytes(8)), False),
    "overlap": (_file({"x": _F32_8, "y": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, bytes(12)), True),
    "past the file": (_file({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, bytes(8)), True),
    "byte count": (_file({"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, bytes(8)), True),
    "header past the file": (_file({"x": _F32_8}, bytes(8), length=10_000), True),
    "header not JSON": (_file({}, bytes(8), raw=b"{not json}"), True),
    "too short": (b"\x01\x00", True),
}


@pytest.mark.parametrize("case", list(_MALFORMED))
def test_reader_refuses_malformed(tmp_path, case):
    data, package_refuses = _MALFORMED[case]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        TW.load_safetensors(path, "cpu")
    if package_refuses:
        with pytest.raises((SafetensorError, ValueError, OSError)):
            load_file(str(path))


def test_reader_defaults_to_the_card(tmp_path):
    path = tmp_path / "t.safetensors"
    save_file({"a": torch.ones(2)}, str(path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TW.load_safetensors(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Qwen3TTS.from_pretrained(tmp_path)


def test_port_needs_no_safetensors_or_tokenizers():
    """The loading path runs where neither ``safetensors``, ``tokenizers``
    nor ``regex`` is installed: importing every port module and loading a
    checkpoint and its tokenizer leaves all three unloaded."""
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, pkgutil, importlib, tempfile, torch, qwen3_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'qwen3_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from qwen3_tts_tpu_torch import ckpt_fixture as cf\n"
        "from qwen3_tts_tpu_torch.tokenizer import TextTokenizer\n"
        "d = tempfile.mkdtemp()\n"
        "cf.write_safetensors(d + '/t.safetensors', {'a': torch.ones(3, dtype=torch.bfloat16)})\n"
        "p.models.weights.load_safetensors(d + '/t.safetensors', 'cpu')\n"
        "cf.write_tokenizer(__import__('pathlib').Path(d))\n"
        "assert TextTokenizer.from_pretrained(d).encode('the <|im_start|>') \n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('safetensors', 'tokenizers', 'regex')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pattern = re.compile(r"^\s*(import|from)\s+(safetensors|tokenizers|regex)\b", re.M)
    assert [str(f) for f in (repo / "qwen3_tts_tpu_torch").rglob("*.py") if pattern.search(f.read_text())] == []
    assert not pattern.search((repo / "chip_smoke.py").read_text())


# -- sidecars, sniffing, layouts ----------------------------------------------


def test_sidecars(tmp_path):
    path = tmp_path / "mimi_config.json"
    assert TP._sidecar_config(path, MimiEncoderConfig) is None
    path.write_text(json.dumps({"ratios": [4, 3], "hidden_size": 16}))
    got = TP._sidecar_config(path, MimiEncoderConfig)
    want = JP._sidecar_config(path, jencoder.MimiEncoderConfig)
    assert got.ratios == (4, 3) and asdict(got) == asdict(want)
    path.write_text(json.dumps({"ratios": [4, 3], "hiden_size": 16}))
    for fn, cls in ((TP._sidecar_config, MimiEncoderConfig), (JP._sidecar_config, jencoder.MimiEncoderConfig)):
        with pytest.raises(ValueError, match="unknown MimiEncoderConfig fields"):
            fn(path, cls)


@pytest.mark.parametrize("hidden,size", [(64, "0.6B"), (2048, "1.7B")])
def test_sniffing_without_config_json(ckpt, tmp_path, monkeypatch, hidden, size):
    """Without config.json both packages sniff the variant from the talker's
    norm (hidden 2048 -> 1.7B, else 0.6B; Base). ``config_for_variant`` is
    recorded and answers with the tiny config, so that the load completes."""
    for f in ckpt.iterdir():
        if f.name != "config.json":
            (shutil.copytree if f.is_dir() else shutil.copy)(f, tmp_path / f.name)
    if hidden != 64:
        raw = load_file(str(ckpt / "model.safetensors"))
        raw["talker.model.norm.weight"] = torch.ones(hidden)
        save_file(raw, str(tmp_path / "model.safetensors"))
    calls = {}
    for name, mod, parse in (("jax", JP, jconfig.parse_config_json), ("port", TP, tconfig.parse_config_json)):
        tiny = parse(ckpt / "config.json")
        monkeypatch.setattr(mod, "config_for_variant",
                            lambda s, v, tiny=tiny, name=name: calls.setdefault(name, (s, v)) and tiny)
    JP.Qwen3TTS.from_pretrained(tmp_path)
    Qwen3TTS.from_pretrained(tmp_path, device="cpu")
    assert calls == {"jax": (size, "base"), "port": (size, "base")}


def test_speech_tokenizer_in_parent_dir(ckpt, tmp_path):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    for f in ckpt.iterdir():
        dest = (tmp_path if f.name == "speech_tokenizer" else model_dir) / f.name
        (shutil.copytree if f.is_dir() else shutil.copy)(f, dest)
    jm = JP.Qwen3TTS.from_pretrained(model_dir, dtype=jnp.float32)
    tm = Qwen3TTS.from_pretrained(model_dir, dtype=torch.float32, device="cpu")
    assert_trees_equal(tm.vocoder_params, TW.from_numpy_tree(_numpy(jm.vocoder_params), "cpu"))
    shutil.rmtree(tmp_path / "speech_tokenizer")
    for load in (lambda: JP.Qwen3TTS.from_pretrained(model_dir),
                 lambda: Qwen3TTS.from_pretrained(model_dir, device="cpu")):
        with pytest.raises(FileNotFoundError, match="Speech tokenizer weights not found"):
            load()


@pytest.mark.parametrize("drop", ["all", "one"])
def test_missing_encoder_keys(ckpt, tmp_path, drop):
    """No ``encoder.*`` tensors, or an incomplete set: no Mimi encoder (ICL
    cloning unavailable), in both packages."""
    shutil.copytree(ckpt, tmp_path / "c")
    st = load_file(str(ckpt / "speech_tokenizer" / "model.safetensors"))
    enc = sorted(k for k in st if k.startswith("encoder."))
    for k in (enc if drop == "all" else [k for k in enc if "downsample" in k]):
        del st[k]
    save_file(st, str(tmp_path / "c" / "speech_tokenizer" / "model.safetensors"))
    tm = Qwen3TTS.from_pretrained(tmp_path / "c", device="cpu")
    jm = JP.Qwen3TTS.from_pretrained(tmp_path / "c")
    assert tm.speech_encoder is None and jm.speech_encoder is None
    assert tm.supports_voice_cloning() and not tm.has_speech_encoder()


def test_encoder_build_errors_other_than_key_sets_raise(ckpt, monkeypatch):
    """Only a malformed ``encoder.*`` set means "no ICL"; another error (as a
    CUDA error would be) raises."""

    def broken(*_a, **_k):
        raise RuntimeError("device error")

    monkeypatch.setattr(Encoder12Hz, "from_weights", broken)
    with pytest.raises(RuntimeError, match="device error"):
        Qwen3TTS.from_pretrained(ckpt, device="cpu")


@pytest.mark.parametrize("size", ["0.6B", "1.7B"])
@pytest.mark.parametrize("kind", ["base", "custom_voice", "voice_design"])
def test_config_json_round_trips(tmp_path, size, kind):
    cfg = tconfig.config_for_variant(size, kind)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(ckpt_fixture.config_json(cfg)))
    assert tconfig.parse_config_json(path) == cfg
    assert asdict(jconfig.parse_config_json(path)) == asdict(cfg)
    cut = ckpt_fixture.utterance_config()
    path.write_text(json.dumps(ckpt_fixture.config_json(cut)))
    assert tconfig.parse_config_json(path) == cut


# -- the slice as a whole -------------------------------------------------------


def _reference() -> np.ndarray:
    """A 0.1 s reference (100 codes of the tiny Mimi encoder)."""
    return (0.3 * np.sin(np.linspace(0, 300, 2400))).astype(np.float32)


@pytest.fixture(scope="module")
def prompts(ckpt):
    jm, tm = models(ckpt, "float32")
    jp = jm.create_voice_clone_prompt(JAudio(_reference(), 24000), REF_TEXT)
    tp = tm.create_voice_clone_prompt(TAudio(_reference(), 24000), REF_TEXT)
    scale = np.abs(jp.speaker_embedding).max()
    np.testing.assert_allclose(tp.speaker_embedding, jp.speaker_embedding, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(tp.ref_codes, jp.ref_codes)
    assert tp.ref_text_ids == jp.ref_text_ids
    return jp, tp


def _close_audio(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _session(model, kind: str, prompt, options):
    if kind == "design":
        return model._voice_design_session(TEXT, INSTRUCT, "english", options)
    if kind == "custom":
        return model._custom_voice_session(TEXT, "ryan", "english", options)
    if kind == "xvector":
        prompt = type(prompt)(prompt.speaker_embedding)
    if isinstance(model, Qwen3TTS):
        return model._voice_clone_session(TEXT, prompt, "english", options)
    session, ref_len = model._voice_clone_session(TEXT, prompt, "english", options)
    if ref_len:
        session.prefix_codes = np.asarray(prompt.ref_codes, np.int32)
    return session


TEMPERATURES = pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])


@TEMPERATURES
def test_synthesize_with_timing_matches_jax(ckpt, temperature):
    jm, tm = models(ckpt, "float32")
    kw = dict(max_length=8, min_new_tokens=8, seed=42, temperature=temperature)
    want = jm._custom_voice_session(TEXT, "ryan", "english", JP.SynthesisOptions(**kw)).run_to_completion()
    got = tm._custom_voice_session(TEXT, "ryan", "english", SynthesisOptions(**kw)).run_to_completion()
    np.testing.assert_array_equal(got, want)
    jaudio, _ = jm.synthesize_with_timing(TEXT, "ryan", "english", JP.SynthesisOptions(**kw))
    taudio, timing = tm.synthesize_with_timing(TEXT, "ryan", "english", SynthesisOptions(**kw))
    assert timing.generation_frames == len(want) == 8
    _close_audio(taudio.samples, jaudio.samples)


@TEMPERATURES
def test_streamed_session_matches_jax(ckpt, temperature):
    jm, tm = models(ckpt, "float32")
    kw = dict(max_length=10, min_new_tokens=10, seed=7, temperature=temperature, chunk_frames=3)
    jchunks = [c.samples for c in jm.synthesize_streaming(TEXT, "ryan", "english", JP.SynthesisOptions(**kw))]
    session = tm.synthesize_streaming(TEXT, "ryan", "english", SynthesisOptions(**kw))
    tchunks = [c.samples for c in session]
    assert [len(c) for c in tchunks] == [len(c) for c in jchunks] == [s * SAMPLES_PER_FRAME for s in (3, 3, 3, 1)]
    _close_audio(np.concatenate(tchunks), np.concatenate(jchunks))
    want = jm._custom_voice_session(TEXT, "ryan", "english", JP.SynthesisOptions(**kw)).run_to_completion()
    np.testing.assert_array_equal(session.state.frames[:10].numpy(), want)


@pytest.mark.parametrize("kind", ["xvector", "icl", "design"])
@TEMPERATURES
def test_clone_and_design_match_jax(ckpt, prompts, kind, temperature):
    """x-vector and ICL cloning and voice design through ``run_to_audio``,
    as ``synthesize_voice_clone`` / ``synthesize_voice_design`` run them."""
    jm, tm = models(ckpt, "float32")
    kw = dict(max_length=8, min_new_tokens=8, seed=42, temperature=temperature)
    jsession = _session(jm, kind, prompts[0], JP.SynthesisOptions(**kw))
    tsession = _session(tm, kind, prompts[1], SynthesisOptions(**kw))
    want, got = jsession.run_to_audio().samples, tsession.run_to_audio().samples
    n = tsession.frames_emitted
    assert n == jsession.frames_emitted == 8
    np.testing.assert_array_equal(tsession.state.frames[:n].numpy(), np.asarray(jsession.state.frames)[:n])
    _close_audio(got, want)
    if kind == "design":
        public = tm.synthesize_voice_design(TEXT, INSTRUCT, "english", SynthesisOptions(**kw))
    else:
        prompt = prompts[1] if kind == "icl" else VoiceClonePrompt(prompts[1].speaker_embedding)
        public = tm.synthesize_voice_clone(TEXT, prompt, "english", SynthesisOptions(**kw))
    np.testing.assert_array_equal(public.samples, got)


@pytest.mark.parametrize("kind", ["xvector", "icl"])
def test_voice_clone_debug_matches_jax(ckpt, prompts, kind):
    """The staged clone: frames equal, the [reference || frames] decode with
    the reference's share cut, within the audio bars."""
    jm, tm = models(ckpt, "float32")
    kw = dict(max_length=8, min_new_tokens=8, seed=3)
    jp, tp = prompts
    if kind == "xvector":
        jp, tp = type(jp)(jp.speaker_embedding), VoiceClonePrompt(tp.speaker_embedding)
    jaudio, jframes = jm.synthesize_voice_clone_debug(TEXT, jp, "english", JP.SynthesisOptions(**kw))
    taudio, tframes = tm.synthesize_voice_clone_debug(TEXT, tp, "english", SynthesisOptions(**kw))
    np.testing.assert_array_equal(tframes, jframes)
    _close_audio(taudio.samples, jaudio.samples)
    assert len(taudio) == len(tframes) * SAMPLES_PER_FRAME


def test_bf16_model_runs_the_same_frames_twice(ckpt):
    _, tm = models(ckpt, "bfloat16")
    opts = SynthesisOptions(max_length=6, min_new_tokens=6, seed=1)
    a = tm._custom_voice_session(TEXT, "ryan", "english", opts).run_to_completion()
    b = tm._custom_voice_session(TEXT, "ryan", "english", opts).run_to_completion()
    assert a.shape == (6, 16)
    np.testing.assert_array_equal(a, b)


def test_vocoder_sidecar_config(ckpt):
    _, tm = models(ckpt, "float32")
    assert tm.vocoder_config != VocoderConfig() and tm.vocoder_config.latent_dim == 24
