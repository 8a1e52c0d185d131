"""A whole utterance at the 1.7B widths, loaded from disk by each package.

``qwen3_tts_tpu_torch.ckpt_fixture.write_utterance_checkpoint`` writes a
seeded HF-layout checkpoint at the 1.7B CustomVoice widths (talker 2048 /
6144, 16 q / 8 KV heads of 128; code predictor 5 layers at 1024 / 3072 with
its 2048 -> 1024 projection; codec vocab 3072; the default full-width
vocoder), cut to 2 talker layers and 4096 drawn text-embedding rows (see the
fixture's docstring), bf16 in the file and the vocoder f32. The JAX
package's ``from_pretrained(dtype=float32)`` ran 24 frames forced, greedy
and under seeded PCG sampling (``synthesize_with_timing``: the staged
decode), and its frames and audio are the committed fixture
``testdata/utterance_1p7b.npz``. The port's ``from_pretrained(device="cpu",
dtype=torch.float32)`` on the same files must give the frames token for
token and the audio within 1e-5 of max|audio|. The fixture also holds the
least top-2 margin of the talker's (post-penalty) and the code predictor's
argmaxes over the greedy run (the port's f32 plain run), so that a
near-tie flip can be told from a fault; ``chip_smoke.py`` holds the card to
the same fixture (phase ``utterance``). ~40 s of CPU, most of it writing
the 1.2 GB checkpoint and the full-width vocoder.

    JAX_PLATFORMS=cpu python tests/test_torch_utterance_1p7b.py   # rewrites the fixture
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu_torch import ckpt_fixture  # noqa: E402
from qwen3_tts_tpu_torch.generation.debug import debug_generate  # noqa: E402
from qwen3_tts_tpu_torch.models import code_predictor as tcp  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer, quant  # noqa: E402
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions  # noqa: E402

AUDIO_TOL = 1e-5  # of max|audio|
TEMPERATURES = {"greedy": 0.0, "pcg": 0.9}


def options(temperature: float, cls=SynthesisOptions):
    n = ckpt_fixture.UTTERANCE_FRAMES
    return cls(max_length=n, min_new_tokens=n, seed=42, temperature=temperature)


def port_run(model: Qwen3TTS, temperature: float) -> tuple[np.ndarray, np.ndarray]:
    """``synthesize_with_timing``'s two stages: every frame, then one
    bucketed decode."""
    session = model._custom_voice_session(ckpt_fixture.UTTERANCE_TEXT, "ryan", "english", options(temperature))
    frames = session.run_to_completion()
    return frames, model.decode_codes(frames).samples


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("utterance")
    ckpt_fixture.write_utterance_checkpoint(root)
    model = Qwen3TTS.from_pretrained(root, dtype=torch.float32, device="cpu")
    for f in root.rglob("*.safetensors"):
        f.unlink()  # the model holds its own f32 copies
    return model


@pytest.mark.parametrize("kind", list(TEMPERATURES))
def test_utterance_matches_jax_fixture(port_model, kind):
    fixture = ckpt_fixture.load_utterance()
    frames, audio = port_run(port_model, TEMPERATURES[kind])
    np.testing.assert_array_equal(frames, fixture[f"frames_{kind}"])
    want = fixture[f"audio_{kind}"]
    assert audio.shape == want.shape == (ckpt_fixture.UTTERANCE_FRAMES * 1920,)
    assert np.abs(audio - want).max() <= AUDIO_TOL * np.abs(want).max()
    assert np.abs(want).max() > 1e-3  # the full-width vocoder's audio has a real scale


def margins(model: Qwen3TTS) -> tuple[float, float]:
    """The least top-2 margins of the talker's post-penalty logits and of the
    code predictor's heads over the greedy run (port, f32, plain ops)."""
    cp_gaps = []
    routed = tcp.predict_acoustic_codes

    def recording(params, cfg, hidden, semantic, *args):
        def mm(x, w):
            y = quant.mm_plain(x, w)
            if y.shape[-1] == cfg.vocab_size:
                top2 = torch.topk(y.float(), 2, dim=-1).values
                cp_gaps.append(float((top2[..., 0] - top2[..., 1]).min()))
            return y

        fused_layer.cp_frame_layers(params, cfg, hidden, semantic, mm)
        return routed(params, cfg, hidden, semantic, *args)

    tcp.predict_acoustic_codes = recording
    try:
        session = model._custom_voice_session(ckpt_fixture.UTTERANCE_TEXT, "ryan", "english", options(0.0))
        trace = debug_generate(model, session, top=2)
    finally:
        tcp.predict_acoustic_codes = routed
    talker_gap = min(float(f.top_logits[0] - f.top_logits[1]) for f in trace.frames)
    return talker_gap, min(cp_gaps)


def write_fixture() -> None:
    import jax.numpy as jnp

    import qwen3_tts_tpu.pipeline as JP

    with tempfile.TemporaryDirectory() as d:
        ckpt_fixture.write_utterance_checkpoint(d)
        jm = JP.Qwen3TTS.from_pretrained(d, dtype=jnp.float32)
        out = {}
        text = ckpt_fixture.UTTERANCE_TEXT
        for kind, t in TEMPERATURES.items():
            session = jm._custom_voice_session(text, "ryan", "english", options(t, JP.SynthesisOptions))
            out[f"frames_{kind}"] = np.asarray(session.run_to_completion(), np.int32)
            audio, _ = jm.synthesize_with_timing(text, "ryan", "english", options(t, JP.SynthesisOptions))
            out[f"audio_{kind}"] = np.asarray(audio.samples, np.float32)
        del jm
        tm = Qwen3TTS.from_pretrained(d, dtype=torch.float32, device="cpu")
        out["talker_margin"], out["cp_margin"] = (np.float32(m) for m in margins(tm))
    np.savez_compressed(ckpt_fixture.UTTERANCE_FIXTURE, **out)
    print({k: v.shape if v.ndim else float(v) for k, v in out.items()},
          {k: float(np.abs(out[f"audio_{k}"]).max()) for k in TEMPERATURES})


if __name__ == "__main__":
    write_fixture()
