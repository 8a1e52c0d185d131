"""The port's command line against the JAX package's, on the CPU.

``python -m qwen3_tts_tpu_torch`` (``qwen3_tts_tpu_torch.cli.main``) runs
here with ``--device cpu`` on the tiny HF-layout checkpoint that
``scripts/make_synthetic_ckpt.py`` writes, loaded by ``from_pretrained``
with its tokenizer files. The CLI loads bf16 weights; bf16 arithmetic
rounds differently in XLA and in PyTorch on the CPU, so where a mode is held
to the JAX package's CLI (``qwen3_tts_tpu.cli.main``, in-process), both
packages' ``from_pretrained`` are made to load f32 (the numerics policy on
the CPU): in every mode, greedy and under seeded PCG sampling, the frames
(``--dump-codes``) are token-exact and the audio handed to ``save_wav``
within atol 1e-5 and 1e-4 of max|audio|. In bf16 the codes of
``--dump-codes``, ``--debug-frames`` and ``--int8`` equal the port's API on
the same loaded model. Also: ``validate_args``'s exclusions and messages,
``--metadata``, ``--compare`` against the JAX package's dumps (IDENTICAL,
and planted divergences found at their frame and stage),
``first_divergence`` against the JAX function, ``--profile`` (a trace file
written) and ``parse_device``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.audio.io as jio
import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu import cli as jcli
from qwen3_tts_tpu.generation.debug import first_divergence as jfirst_divergence
from qwen3_tts_tpu_torch import cli as tcli
from qwen3_tts_tpu_torch.audio import io as tio
from qwen3_tts_tpu_torch.generation.debug import first_divergence
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from qwen3_tts_tpu_torch.utils.device import device_info, parse_device, sync_device
from scripts.make_synthetic_ckpt import write_ckpt

torch.set_num_threads(1)

TEXT = "Say it from the command line."
FRAMES = 8


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = write_ckpt(tmp_path_factory.mktemp("ckpt"))
    tio.save_wav(root / "ref.wav", (0.3 * np.sin(np.linspace(0, 300, 2400))).astype(np.float32), 24000)
    return root


def _parse(cli, argv):
    return cli.build_parser().parse_args(["--model-dir", "/tmp/x", *argv])


@pytest.mark.parametrize("argv", [
    ["--instruct", "deep voice", "--ref-audio", "a.wav"],
    ["--ref-text", "hello"],
    ["--x-vector-only"],
    ["--x-vector-only", "--ref-audio", "a.wav", "--ref-text", "t"],
], ids=["instruct+ref-audio", "ref-text alone", "x-vector-only alone", "x-vector-only+ref-text"])
def test_validate_args_exclusions(argv):
    with pytest.raises(SystemExit) as got:
        tcli.validate_args(_parse(tcli, argv))
    with pytest.raises(SystemExit) as want:
        jcli.validate_args(_parse(jcli, argv))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [[], ["--instruct", "a voice"], ["--ref-audio", "a.wav"],
                                  ["--ref-audio", "a.wav", "--ref-text", "t"],
                                  ["--ref-audio", "a.wav", "--x-vector-only"], ["--streaming", "--chunk-frames", "5"]])
def test_validate_args_passes(argv):
    tcli.validate_args(_parse(tcli, argv))


def test_flags_match_jax_and_duration_overrides_frames():
    """The JAX CLI's flags in its order, its defaults, then ``--device``."""
    tflags = [a.dest for a in tcli.build_parser()._actions]
    jflags = [a.dest for a in jcli.build_parser()._actions]
    assert tflags == jflags + ["device"]
    args = _parse(tcli, ["--duration", "4.0", "--frames", "999"])
    assert int(args.duration * 12.5) == 50 and args.device == "cuda"
    for dest in jflags:
        if dest != "help":
            assert getattr(_parse(tcli, []), dest) == getattr(_parse(jcli, []), dest), dest


def _run(cli, argv, monkeypatch, capsys, dtype=None) -> dict:
    """``cli.main(argv)`` in-process: the loaded model, the samples handed to
    ``save_wav``, stderr. ``dtype``: the dtype both packages'
    ``from_pretrained`` are made to load (else the CLI's bf16)."""
    jax_side = cli is jcli
    cls, io = (JP.Qwen3TTS, jio) if jax_side else (Qwen3TTS, tio)
    loader = cls.__dict__["from_pretrained"].__func__
    seen = {}

    def load(klass, *a, **k):
        if dtype is not None:
            k["dtype"] = getattr(jnp if jax_side else torch, dtype)
        seen["model"] = loader(klass, *a, **k)
        return seen["model"]

    real_save = io.save_wav

    def save(path, samples, rate):
        seen["audio"] = np.asarray(samples, np.float32)
        real_save(path, samples, rate)

    monkeypatch.setattr(cls, "from_pretrained", classmethod(load))
    monkeypatch.setattr(io, "save_wav", save)
    capsys.readouterr()
    assert cli.main(argv) == 0
    seen["stderr"] = capsys.readouterr().err
    monkeypatch.undo()
    return seen


def _argv(ckpt, out, *extra, temperature=0.9):
    argv = ["-m", str(ckpt), "-t", TEXT, "-f", str(FRAMES), "--min-new-tokens", str(FRAMES), "--seed", "42",
            "--temperature", str(temperature), "--output", str(out), *extra]
    return argv


MODES = {
    "default": [],
    "streaming": ["--streaming", "--chunk-frames", "3"],
    "instruct": ["--instruct", "a calm, low voice"],
    "x-vector": ["--ref-audio", "{ref}", "--x-vector-only", "--dump-codes"],
    "icl": ["--ref-audio", "{ref}", "--ref-text", "Reference words.", "--dump-codes"],
    "debug-frames": ["--debug-frames"],
    "dump-codes": ["--dump-codes"],
}


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])
@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax_cli(ckpt, tmp_path, monkeypatch, capsys, mode, temperature):
    extra = [a.replace("{ref}", str(ckpt / "ref.wav")) for a in MODES[mode]]
    got = _run(tcli, _argv(ckpt, tmp_path / "t.wav", *extra, "--device", "cpu", temperature=temperature),
               monkeypatch, capsys, "float32")
    want = _run(jcli, _argv(ckpt, tmp_path / "j.wav", *extra, temperature=temperature), monkeypatch, capsys,
                "float32")
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], rtol=0, atol=1e-5)
    assert np.abs(got["audio"] - want["audio"]).max() <= 1e-4 * np.abs(want["audio"]).max()
    codes = tmp_path / "t.codes.bin"
    assert codes.exists() == (tmp_path / "j.codes.bin").exists()
    if codes.exists():
        np.testing.assert_array_equal(np.fromfile(codes, np.int32), np.fromfile(tmp_path / "j.codes.bin", np.int32))
    for line in ("Variant: 0.6B Base", "Voice cloning mode: icl", "Voice cloning mode: x_vector_only", "TTFA:",
                 "chunk 1:", "frame    0 | semantic", "warning: --instruct on a 0.6B Base model",
                 "warning: preset speaker on a Base model", "| generation"):
        assert (line in got["stderr"]) == (line in want["stderr"]), line
    assert f"{FRAMES} frames)" in got["stderr"]


def _api_codes(model, temperature=0.9) -> np.ndarray:
    opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=temperature)
    return model.synthesize_streaming(TEXT, "ryan", "english", opts).run_to_completion()


@pytest.mark.parametrize("extra", [["--dump-codes"], ["--debug-frames", "3"], ["--dump-codes", "--int8"]],
                         ids=["dump-codes", "debug-frames", "int8"])
def test_bf16_codes_equal_the_api(ckpt, tmp_path, monkeypatch, capsys, extra):
    """The CLI's own bf16 (and int8) load: the dumped codes are the API's on
    the same model (``--debug-frames`` drives the production loop)."""
    out = tmp_path / "out.wav"
    seen = _run(tcli, _argv(ckpt, out, *extra, "--device", "cpu"), monkeypatch, capsys)
    model = seen["model"]
    assert model.compute_dtype == torch.bfloat16
    if "--int8" in extra:
        assert model.talker_params["layers"]["qkv_proj"]["q8"].dtype == torch.int8
    codes = np.fromfile(out.with_suffix(".codes.bin"), np.int32).reshape(-1, 16)
    np.testing.assert_array_equal(codes, _api_codes(model))
    if "--debug-frames" in extra:
        assert seen["stderr"].count("| semantic") == 3


def test_metadata_and_wav(ckpt, tmp_path, monkeypatch, capsys):
    out = tmp_path / "out.wav"
    seen = _run(tcli, _argv(ckpt, out, "--metadata", "--device", "cpu"), monkeypatch, capsys)
    wav = tio.load_wav(out)
    assert wav.sample_rate == 24000 and len(wav) == FRAMES * SAMPLES_PER_FRAME == len(seen["audio"])
    meta = json.loads(out.with_suffix(".json").read_text())
    assert meta["num_frames"] == FRAMES and meta["seed"] == 42 and meta["audio_samples"] == len(wav)
    assert meta["sample_rate"] == 24000 and meta["rtf"] > 0
    assert "prefill" in seen["stderr"] and "RTF" in seen["stderr"]


def test_output_dir_naming(ckpt, tmp_path, monkeypatch, capsys):
    argv = ["-m", str(ckpt), "-t", TEXT, "-f", "3", "-o", str(tmp_path / "gen"), "--device", "cpu"]
    _run(tcli, argv, monkeypatch, capsys)
    assert (tmp_path / "gen" / "audio_seed42_frames3.wav").exists()


def test_compare_against_jax_dumps(ckpt, tmp_path, monkeypatch, capsys):
    """``--compare`` with the JAX package's codes and audio as the reference
    dumps: IDENTICAL; then a planted acoustic and a planted semantic
    divergence, each reported at its frame and stage."""
    want = _run(jcli, _argv(ckpt, tmp_path / "j.wav", "--dump-codes"), monkeypatch, capsys, "float32")
    ref = tmp_path / "ref"
    ref.mkdir()
    codes = np.fromfile(tmp_path / "j.codes.bin", np.int32).reshape(-1, 16)
    codes.tofile(ref / "codes_seed42.bin")
    want["audio"].astype(np.float32).tofile(ref / "audio_seed42.bin")
    argv = _argv(ckpt, tmp_path / "t.wav", "--compare", str(ref), "--device", "cpu")
    err = _run(tcli, argv, monkeypatch, capsys, "float32")["stderr"]
    assert "compare codes: IDENTICAL" in err and "mismatch fraction 0.0000" in err
    diff = float(err.split("compare audio: max|Δ| ")[1].split()[0])
    assert diff <= 1e-5
    for frame, group, stage in ((5, 7, "acoustic group 7 (code predictor)"), (2, 0, "semantic (talker sampling)")):
        planted = codes.copy()
        planted[frame, group] += 1
        planted.tofile(ref / "codes_seed42.bin")
        err = _run(tcli, argv, monkeypatch, capsys, "float32")["stderr"]
        assert f"first divergence at frame {frame} in {stage}" in err


@pytest.mark.parametrize("case", ["equal", "semantic", "acoustic", "longer", "shorter"])
def test_first_divergence_matches_jax(case):
    rs = np.random.RandomState(0)
    ours = rs.randint(0, 2048, (6, 16)).astype(np.int32)
    ref = ours.copy()
    if case == "semantic":
        ref[3, 0] += 1
    elif case == "acoustic":
        ref[4, 9] += 1
        ref[4, 12] += 1
    elif case == "longer":
        ref = ref[:4]
    elif case == "shorter":
        ref = np.concatenate([ref, ref[:2]])
    assert first_divergence(ours, ref) == jfirst_divergence(ours, ref)
    assert (first_divergence(ours, ref) is None) == (case == "equal")


def test_profile_writes_a_trace(ckpt, tmp_path, monkeypatch, capsys):
    trace = tmp_path / "trace"
    seen = _run(tcli, _argv(ckpt, tmp_path / "out.wav", "--profile", str(trace), "--device", "cpu"), monkeypatch,
                capsys)
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert len(events) > 0 and f"profiler trace written to {trace}" in seen["stderr"]


def test_parse_device():
    assert parse_device("cpu") == torch.device("cpu") and parse_device(" CPU ") == torch.device("cpu")
    assert device_info("cpu") == "cpu"
    sync_device(torch.zeros(1))
    for bad in ("tpu", "gpu", "cuda:x"):
        with pytest.raises(ValueError):
            parse_device(bad)
    if not torch.cuda.is_available():
        for spec in ("auto", "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                parse_device(spec)
    else:
        assert parse_device("auto") == parse_device("cuda") == torch.device("cuda", 0)


def test_cli_runs_on_the_card_by_default(ckpt, tmp_path):
    """Without ``--device`` the CLI asks for the card; without one it raises
    rather than running on the CPU."""
    assert tcli.build_parser().parse_args(["-m", str(ckpt)]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["-m", str(ckpt), "-t", TEXT, "-f", "2", "--output", str(tmp_path / "x.wav")])
        assert not (tmp_path / "x.wav").exists()
