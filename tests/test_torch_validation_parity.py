"""The port's parity matrix and golden stages against the JAX side (CPU).

On the tiny synthetic checkpoint of ``scripts/make_synthetic_ckpt.py`` (the
weights ``tests/test_dump_producer.py`` builds, with the vocoder and Mimi
sidecars that ``from_pretrained`` reads in both packages):

* the parity matrix's solo f32 greedy cell (``from_pretrained(dtype=f32)``,
  temperature 0.001, the first text): the port's frames token-exact to the
  JAX package's, the audio within atol 1e-5; the port's own
  ``parity_matrix.main`` exits 0 on a CPU mesh of dp = 2 x tp = 2, naming
  the shared ranks, and ``mesh_devices`` takes four distinct cards where
  there are four;
* the golden stages (the port's counterpart of ``test_dump_producer.py``):
  ``scripts/dump_reference_values.main`` (the torch oracle) dumps the
  checkpoint's stages, and the port's ``golden_stages`` holds each to the
  dump with that file's tolerances (text embedding 1e-6, projection 1e-5,
  the talker's logits 1e-4, the vocoder 1e-4) and the seed-42 [T, 16] code
  matrix token-exact; ``parity --golden`` passes on the dump;
* the real-dump form (``tests/test_reference_golden.py``'s tolerances)
  skips when ``test_data/reference_values/metadata.json`` is absent.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS
from qwen3_tts_tpu.pipeline import SynthesisOptions as JOptions
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from qwen3_tts_tpu_torch.validation import __main__ as chain
from qwen3_tts_tpu_torch.validation import parity_matrix
from scripts.make_synthetic_ckpt import write_ckpt

torch.set_num_threads(1)

FRAMES = 6
TEXT = "parity matrix drill"
GOLDEN_DIR = Path(__file__).resolve().parent.parent / "test_data" / "reference_values"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_ckpt(tmp_path_factory.mktemp("synth") / "ckpt")


def test_solo_f32_greedy_matches_jax(ckpt):
    jm = JQwen3TTS.from_pretrained(ckpt, dtype=jnp.float32)
    tm = Qwen3TTS.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    jopts = JOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.001)
    topts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.001)
    want = np.asarray(jm._custom_voice_session(TEXT, "ryan", "english", jopts).run_to_completion())
    got = tm._custom_voice_session(TEXT, "ryan", "english", topts).run_to_completion()
    assert got.shape == want.shape == (FRAMES, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tm.decode_codes(got).samples, np.asarray(jm.decode_codes(want).samples),
                               rtol=0, atol=1e-5)


def test_parity_matrix_main_on_a_cpu_mesh(ckpt, capsys):
    assert parity_matrix.main(["--model-dir", str(ckpt), "--device", "cpu", "--frames", str(FRAMES)]) == 0
    out = capsys.readouterr().out
    assert "dp=2 x tp=2 on ranks sharing cpu" in out and "parity matrix OK: 6/6 cells" in out


def test_mesh_devices(monkeypatch):
    assert parity_matrix.mesh_devices(torch.device("cpu")) == ([torch.device("cpu")] * 4, "ranks sharing cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    devices, placement = parity_matrix.mesh_devices(torch.device("cuda", 0))
    assert devices == [torch.device("cuda", i) for i in range(4)] and placement == "distinct cards"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parity_matrix.mesh_devices(torch.device("cuda", 0))[0] == [torch.device("cuda", 0)] * 4


@pytest.fixture(scope="module")
def dumped(ckpt, tmp_path_factory):
    from scripts import dump_reference_values as DRV

    out = tmp_path_factory.mktemp("golden")
    assert DRV.main(["--model-dir", str(ckpt), "--text", "hello world", "--seed", "42", "--max-frames", str(FRAMES),
                     "--out", str(out)]) == 0
    return out


def test_golden_stages_match_the_dump(ckpt, dumped):
    meta = json.loads((dumped / "metadata.json").read_text())
    assert meta["seed"] == 42 and set(meta["stages"]) >= {"text_embedding", "text_projection", "talker_forward",
                                                          "codes", "vocoder_waveform"}
    model = Qwen3TTS.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    assert model.tokenizer.encode(meta["text"]) == meta["input_ids"]
    got = chain.golden_stages(model, dumped)
    assert got["text_embedding"] < 1e-6
    assert got["text_projection"] < 1e-5
    assert got["talker_forward"] < 1e-4
    assert got["vocoder_waveform"] < 1e-4
    assert got["codes_share"] == 1.0  # the seed-42 [T, 16] codes token-exact


def test_parity_golden_step_passes(ckpt, dumped, capsys):
    assert chain._golden(str(ckpt), str(dumped), torch.device("cpu")) == 0
    out = capsys.readouterr().out
    assert "golden: PASS" in out and "golden codes_share: 1.0000e+00 (reported)" in out


def test_golden_stages_against_real_dumps():
    if not (GOLDEN_DIR / "metadata.json").exists():
        pytest.skip("no reference dumps (test_data/reference_values/metadata.json)")
    meta = json.loads((GOLDEN_DIR / "metadata.json").read_text())
    if not Path(meta["model_dir"]).exists():
        pytest.skip(f"checkpoint {meta['model_dir']} not present")
    assert chain._golden(meta["model_dir"], str(GOLDEN_DIR), torch.device("cpu")) == 0
