"""The two encoders of voice cloning at full width, the JAX package and the
port, on the CPU in f32.

Seeded numpy weights for the speaker encoder at the 1.7B Base checkpoint's
enc_dim 2048 and for the Mimi encoder at ``MimiEncoderConfig()``, and two
seeded 3 s references (24 kHz, and 16 kHz resampled to 24 kHz first), from
``qwen3_tts_tpu_torch.encoder_fixture``, go to both packages. The JAX
package's ``SpeakerEncoder.encode`` and ``Encoder12Hz.encode`` (mel frames
and samples bucketed and masked, f32 at HIGHEST precision) must give the
committed fixture, and the port's encoders (at the true length, on
``F.conv1d``) the same: x-vectors within 1e-5 of max|x|, codes equal code
for code. The fixture also holds each code's distance margin to the
runner-up codeword, so that a near-tie flip can be told from a fault.
``chip_smoke.py`` holds the port's encoders on the card to the same
fixture. ~20 s of CPU.

    JAX_PLATFORMS=cpu python tests/test_torch_encoders_full.py   # rewrites the fixture
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu.audio import resample as jresample  # noqa: E402
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio  # noqa: E402
from qwen3_tts_tpu.models import speaker as jspeaker  # noqa: E402
from qwen3_tts_tpu.models.codec import encoder as jencoder  # noqa: E402
from qwen3_tts_tpu.models.config import config_for_variant as jconfig_for_variant  # noqa: E402
from qwen3_tts_tpu_torch import encoder_fixture as fx  # noqa: E402
from qwen3_tts_tpu_torch.audio import resample as tresample  # noqa: E402
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio  # noqa: E402
from qwen3_tts_tpu_torch.models import speaker as tspeaker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as TW  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import encoder as tencoder  # noqa: E402

torch.set_num_threads(2)

XVEC_REL = 1e-5  # of max|x-vector|
# A squared-distance gap below this could flip under another summation
# order: 5x the largest difference between the two packages' gaps on the
# CPU (3.7e-4, at squared distances of ~256). The fixture's references have
# none.
MIN_MARGIN = 2e-3


def jax_encoders():
    jspk = jspeaker.SpeakerEncoder(jax.tree.map(jnp.asarray, fx.speaker_numpy_params(fx.speaker_config())),
                                   jconfig_for_variant("1.7B", "base").speaker_encoder)
    jmimi = jencoder.Encoder12Hz(jax.tree.map(jnp.asarray, fx.mimi_numpy_params(fx.mimi_config())),
                                 jencoder.MimiEncoderConfig())
    return jspk, jmimi


def jax_margins(jmimi, samples: np.ndarray) -> np.ndarray:
    """[T, 16] distance gaps of the JAX package's codes (unbucketed forward)."""
    p, cfg = jmimi.params, jmimi.cfg
    h = jencoder._seanet_encoder(p["seanet"], cfg, jnp.asarray(samples)[None, :, None])
    h = jencoder._transformer(p["transformer"], cfg, h)
    h = jencoder._mimi_conv(h, p["downsample_w"], None, stride=cfg.downsample_stride, pad_mode="replicate")
    t = torch.from_numpy(np.asarray(h))
    gaps = [tencoder.rvq_margins(t, torch.from_numpy(np.asarray(p[f"{k}_proj"])),
                                 torch.from_numpy(np.asarray(p[f"{k}_codebooks"]))) for k in ("semantic", "acoustic")]
    return torch.cat(gaps)[:, 0].T.numpy()


def jax_outputs(jspk, jmimi, rate: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    audio = JAudio(fx.reference_audio(rate), rate)
    if rate != 24000:
        audio = jresample.resample_to_24k(audio)
    return jspk.encode(audio.samples), jmimi.encode(audio.samples), audio.samples


def assert_matches_fixture(xvec: np.ndarray, codes: np.ndarray, want: dict, rate: int) -> None:
    wx, wc = want[f"xvector_{rate}"], want[f"codes_{rate}"]
    assert xvec.shape == wx.shape == (fx.speaker_config().enc_dim,) and np.isfinite(xvec).all()
    np.testing.assert_allclose(xvec, wx, rtol=0, atol=XVEC_REL * np.abs(wx).max())
    assert codes.shape == wc.shape
    diff = np.argwhere(codes != wc)
    margins = [float(want[f"margin_{rate}"][t, q]) for t, q in diff]
    assert diff.size == 0, f"{rate} Hz: codes differ at (frame, quantizer) {diff.tolist()}, margins {margins}"


@pytest.fixture(scope="module")
def want():
    return fx.load()


def test_configs_agree():
    """The fixture's configurations are the JAX package's, field for field."""
    jm, tm = jencoder.MimiEncoderConfig(), fx.mimi_config()
    assert {f: getattr(tm, f) for f in tm.__dataclass_fields__} == {f: getattr(jm, f) for f in jm.__dataclass_fields__}
    js, ts = jconfig_for_variant("1.7B", "base").speaker_encoder, fx.speaker_config()
    assert {f: getattr(ts, f) for f in ts.__dataclass_fields__} == {f: getattr(js, f) for f in js.__dataclass_fields__}
    assert ts.enc_dim == 2048


def test_fixture_is_well_conditioned(want):
    """Both references give 38 frames of 16 codes spread over the codebooks,
    every code at least MIN_MARGIN from a tie, and x-vectors of a real scale."""
    for rate in fx.RATES:
        codes, margin, xvec = want[f"codes_{rate}"], want[f"margin_{rate}"], want[f"xvector_{rate}"]
        assert codes.shape == (38, 16) and codes.dtype == np.int32
        assert len(np.unique(codes)) > 200
        assert margin.min() >= MIN_MARGIN
        assert 0.1 < np.abs(xvec).max() < 100 and xvec.std() > 0.01
    assert not np.array_equal(want["codes_24000"], want["codes_16000"])


def test_jax_package_gives_the_fixture(want):
    jspk, jmimi = jax_encoders()
    for rate in fx.RATES:
        xvec, codes, _ = jax_outputs(jspk, jmimi, rate)
        assert_matches_fixture(xvec, codes, want, rate)


def test_port_gives_the_fixture(want):
    tspk = tspeaker.SpeakerEncoder(TW.speaker_encoder_from_numpy(fx.speaker_numpy_params(fx.speaker_config()), "cpu"),
                                   fx.speaker_config())
    tmimi = tencoder.Encoder12Hz(TW.mimi_encoder_from_numpy(fx.mimi_numpy_params(fx.mimi_config()), "cpu"),
                                 fx.mimi_config())
    for rate in fx.RATES:
        audio = TAudio(fx.reference_audio(rate), rate)
        if rate != 24000:
            audio = tresample.resample_to_24k(audio)
        assert_matches_fixture(tspk.encode(audio.samples), tmimi.encode(audio.samples), want, rate)


if __name__ == "__main__":
    jspk, jmimi = jax_encoders()
    out = {}
    for rate in fx.RATES:
        xvec, codes, samples = jax_outputs(jspk, jmimi, rate)
        out[f"xvector_{rate}"] = xvec.astype(np.float32)
        out[f"codes_{rate}"] = codes.astype(np.int32)
        out[f"margin_{rate}"] = jax_margins(jmimi, samples).astype(np.float32)
        print(f"{rate} Hz: {len(samples)} samples at 24 kHz, codes {codes.shape}, max|x| "
              f"{np.abs(xvec).max():.4f}, min margin {out[f'margin_{rate}'].min():.4f}")
    np.savez(fx.FIXTURE, **out)
    print(f"wrote {fx.FIXTURE}")
