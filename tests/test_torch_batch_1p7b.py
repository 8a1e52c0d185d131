"""A batch of three utterances at the 1.7B widths, against the JAX package.

The seeded 1.7B-width checkpoint of ``qwen3_tts_tpu_torch.ckpt_fixture``
(``write_utterance_checkpoint``: the 1.7B CustomVoice widths, 2 talker
layers) went through the JAX package's ``from_pretrained(dtype=float32)``
and ``synthesize_batch`` of ``ckpt_fixture.BATCH_TEXTS`` (three texts of
different lengths, seeds 42, 43, 44, ``BATCH_FRAMES`` frames forced),
greedy and under seeded PCG sampling; its frames and audio are the
committed fixture ``testdata/batch_1p7b.npz``. The port's
``synthesize_batch`` on the same files (f32, CPU) must give every stream's
frames token for token and its audio within 1e-5 of its max|audio|. The
fixture also holds the least top-2 margins of the talker's (post-penalty)
and the code predictor's argmaxes over the greedy batch (the port's f32
plain run), so that a near-tie flip can be told from a fault;
``chip_smoke.py`` phase ``batch`` holds the card to the same fixture.

    JAX_PLATFORMS=cpu python tests/test_torch_batch_1p7b.py   # rewrites the fixture
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu_torch import ckpt_fixture  # noqa: E402
from qwen3_tts_tpu_torch.ops import quant, sampling  # noqa: E402
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions  # noqa: E402

AUDIO_TOL = 1e-5  # of each stream's max|audio|
TEMPERATURES = {"greedy": 0.0, "pcg": 0.9}
SEEDS = [42, 43, 44]


def options(temperature: float, cls=SynthesisOptions):
    n = ckpt_fixture.BATCH_FRAMES
    return cls(max_length=n, min_new_tokens=n, seed=SEEDS[0], temperature=temperature)


def port_run(model: Qwen3TTS, temperature: float) -> tuple[np.ndarray, np.ndarray]:
    """The batch's frames [B, T, 16] (its one layout group) and audio [B, T * 1920]."""
    texts = list(ckpt_fixture.BATCH_TEXTS)
    group = model._prepare_batch_group("basic", texts, ["ryan"] * 3, ["english"] * 3, [None] * 3,
                                       options(temperature), SEEDS)
    frames, counts = model._generate_batch_group(group)
    audio = model.synthesize_batch(texts, options=options(temperature))
    return (np.stack([f[:n] for f, n in zip(frames, counts)]),
            np.stack([a.samples for a in audio]))


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch")
    ckpt_fixture.write_utterance_checkpoint(root)
    model = Qwen3TTS.from_pretrained(root, dtype=torch.float32, device="cpu")
    for f in root.rglob("*.safetensors"):
        f.unlink()  # the model holds its own f32 copies
    return model


@pytest.mark.parametrize("kind", list(TEMPERATURES))
def test_batch_matches_jax_fixture(port_model, kind):
    fixture = ckpt_fixture.load_batch()
    frames, audio = port_run(port_model, TEMPERATURES[kind])
    np.testing.assert_array_equal(frames, fixture[f"frames_{kind}"])
    want = fixture[f"audio_{kind}"]
    assert audio.shape == want.shape == (3, ckpt_fixture.BATCH_FRAMES * 1920)
    for got_i, want_i in zip(audio, want):
        assert np.abs(got_i - want_i).max() <= AUDIO_TOL * np.abs(want_i).max()
        assert np.abs(want_i).max() > 1e-3  # the full-width vocoder's audio has a real scale


def margins(model: Qwen3TTS) -> tuple[float, float]:
    """The least top-2 margins of the talker's post-penalty logits (the
    greedy sampler's input) and of the code predictor's heads over the
    greedy batch (port, f32, plain ops)."""
    cp_vocab = model.config.code_predictor.vocab_size
    talker_gaps, cp_gaps = [], []
    routed_mm, routed_sample = quant.mm, sampling.sample_rows

    def top2_gap(y):
        top2 = torch.topk(y.float(), 2, dim=-1).values
        return float((top2[..., 0] - top2[..., 1]).min())

    def mm(x, w):
        y = routed_mm(x, w)
        if y.shape[-1] == cp_vocab:
            cp_gaps.append(top2_gap(y))
        return y

    def sample(logits, cfg, uniform):
        talker_gaps.append(top2_gap(logits))
        return routed_sample(logits, cfg, uniform)

    quant.mm, sampling.sample_rows = mm, sample
    try:
        port_run(model, 0.0)
    finally:
        quant.mm, sampling.sample_rows = routed_mm, routed_sample
    return min(talker_gaps), min(cp_gaps)


def write_fixture() -> None:
    import jax.numpy as jnp

    import qwen3_tts_tpu.pipeline as JP

    texts = list(ckpt_fixture.BATCH_TEXTS)
    with tempfile.TemporaryDirectory() as d:
        ckpt_fixture.write_utterance_checkpoint(d)
        jm = JP.Qwen3TTS.from_pretrained(d, dtype=jnp.float32)
        out = {}
        for kind, t in TEMPERATURES.items():
            opts = options(t, JP.SynthesisOptions)
            frames, counts, _ = jm._generate_batch_group("basic", texts, ["ryan"] * 3, ["english"] * 3,
                                                         [None] * 3, opts, SEEDS)
            out[f"frames_{kind}"] = np.stack([f[:n] for f, n in zip(frames, counts)]).astype(np.int32)
            audio = jm.synthesize_batch(texts, options=opts)
            out[f"audio_{kind}"] = np.stack([a.samples for a in audio]).astype(np.float32)
            print(kind, "done", flush=True)
        del jm
        tm = Qwen3TTS.from_pretrained(d, dtype=torch.float32, device="cpu")
        out["talker_margin"], out["cp_margin"] = (np.float32(m) for m in margins(tm))
    np.savez_compressed(ckpt_fixture.BATCH_FIXTURE, **out)
    print({k: v.shape if v.ndim else float(v) for k, v in out.items()},
          {k: np.abs(out[f"audio_{k}"]).max(axis=1).tolist() for k in TEMPERATURES})


if __name__ == "__main__":
    write_fixture()
