"""The port's audio quality gate (``validation/quality.py``) against the JAX
side's ``scripts/quality_check.py`` (CPU).

On WAVs written here (silence, clipping, a DC offset, too short, a normal
tone, and a directory of all of them) ``check_wav`` gives the script's
dict, and ``main --json`` prints the script's JSON and returns its exit
code, at the default gates and at the drill's lenient ones. The port's
optional ``transcribe`` callable adds the word error rate (and a failure
past ``max_wer``) and leaves every other key as it was.
"""

import json
import sys
import numpy as np
import pytest

from qwen3_tts_tpu_torch.audio.io import save_wav
from qwen3_tts_tpu_torch.validation import quality
from scripts import quality_check

RATE = 24000


def _tone(seconds: float, amp: float = 0.3, dc: float = 0.0, lead: float = 0.0) -> np.ndarray:
    t = np.arange(int(seconds * RATE)) / RATE
    x = amp * np.sin(2 * np.pi * 220.0 * t) + dc
    x[: int(lead * RATE)] = 0.0
    return x.astype(np.float32)


WAVS = {
    "silence": np.zeros(RATE, np.float32),
    "clipping": np.clip(_tone(1.0, amp=3.0), -1, 1),
    "dc": _tone(1.0, amp=0.2, dc=0.1),
    "short": _tone(0.1),
    "tone": _tone(1.5),
    "late": _tone(3.0, lead=2.5),
}


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for name, x in WAVS.items():
        save_wav(root / f"{name}.wav", x, RATE)
    return root


@pytest.mark.parametrize("name", sorted(WAVS))
def test_check_wav_matches_script(wavs, name):
    want = quality_check.check_wav(wavs / f"{name}.wav")
    got = quality.check_wav(wavs / f"{name}.wav")
    assert got == want
    assert got["pass"] == (name == "tone")


LENIENT = ["--min-rms", "0", "--max-clipping", "1", "--max-leading-silence", "99", "--max-dc", "1"]


@pytest.mark.parametrize("flags", [[], LENIENT], ids=["default", "drill"])
@pytest.mark.parametrize("which", ["tone", "silence", "dir"])
def test_main_json_matches_script(wavs, capsys, monkeypatch, which, flags):
    argv = [str(wavs if which == "dir" else wavs / f"{which}.wav"), "--json", *flags]
    monkeypatch.setattr(sys, "argv", ["quality_check.py", *argv])
    want_rc = quality_check.main()
    want = capsys.readouterr().out
    got_rc = quality.main(argv)
    got = capsys.readouterr().out
    assert got == want and got_rc == want_rc
    assert got_rc == int(which == "dir" or (which == "silence" and not flags))  # "short" fails every gate
    assert len(json.loads(got)) == (len(WAVS) if which == "dir" else 1)


def test_main_without_wavs_exits(tmp_path):
    with pytest.raises(SystemExit, match="no WAV files"):
        quality.main([str(tmp_path)])


def test_transcribe_adds_the_word_error_rate(wavs):
    path = wavs / "tone.wav"
    heard = {str(path): "the stars wheeled overhead"}
    base = quality.check_wav(path)
    got = quality.check_wav(path, transcribe=lambda p: heard[str(p)], text="The stars wheeled slowly overhead")
    assert got["transcript"] == "the stars wheeled overhead" and got["wer"] == 0.2
    assert {k: v for k, v in got.items() if k not in ("transcript", "wer")} == base
    gated = quality.check_wav(path, transcribe=lambda p: heard[str(p)], text="a b c", max_wer=0.5)
    assert not gated["pass"] and gated["failures"] == ["wer 133.33% > 50.00%"]
    assert quality.word_error_rate("a b c", "a b c") == 0.0
