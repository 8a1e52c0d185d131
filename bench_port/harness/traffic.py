"""One general generator of requests from a traffic mix's parameters and a seed.

A mix file (``bench_port/traffic/<mix>.json``) gives:

* ``entry``: ``utterance`` (``Qwen3TTS.synthesize_with_voice``) or ``stream``
  (``Qwen3TTS.synthesize_streaming``, pulled chunk by chunk);
* ``frames``: [lo, hi], the codec frames a request is forced to (12.5 a
  second of audio), and ``strata``: how many evenly spaced lengths a block
  of requests holds. Every seed gets the same lengths in each block, in its
  own order, so seeds change the order of the work and not its amount;
* ``text_tokens``: [lo, hi], the text's length, rising with the frames;
* ``temperature``, and ``greedy_every``: every k-th request (the first among
  them) is greedy with no repetition penalty, so that the check can judge its
  codes against the reference;
* for streams: ``streaming_lookahead``, ``chunk_frames``, ``first_chunk_frames``;
* ``warmup``: [[frames, text tokens], ...], the requests set-up runs, one
  sampled and one greedy of each;
* ``check_requests``: how many greedy requests the check judges, the longest
  among them.

Speakers are the nine presets, taken in turn, each in its own language. The
loop is closed with one client (``"clients": 1``, ``"loop": "closed"``): the
next request is sent when the last one has returned.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Preset speakers of the CustomVoice models: codec token and language (the
# published model's table).
SPEAKERS = {
    "serena": (3066, "chinese"), "vivian": (3065, "chinese"), "uncle_fu": (3010, "chinese"),
    "ryan": (3061, "english"), "aiden": (2861, "english"), "ono_anna": (2873, "japanese"),
    "sohee": (2864, "korean"), "eric": (2875, "chinese"), "dylan": (2878, "chinese"),
}
# Codec tokens of the languages.
LANGUAGES = {"chinese": 2055, "english": 2050, "japanese": 2058, "korean": 2064}

WORDS = ("the voice of a reader carries each line across the room while the river keeps its slow time under "
         "bridges and lamps of an old town where people gather to listen talk and wait for news from far away "
         "places that nobody here has seen").split()


class WordTokenizer:
    """One token a word. A frozen copy of ``WordTokenizer`` in
    ``qwen3_tts_tpu_torch/synthesis_timing.py``: the published Qwen2
    vocabulary is not in the repository."""

    def encode(self, text: str) -> list[int]:
        return [200 + (sum(map(ord, w)) * 37) % 1000 for w in text.split()]


@dataclass(frozen=True)
class Request:
    index: int
    frames: int
    text: str
    speaker: str
    language: str
    greedy: bool
    seed: int

    @property
    def speaker_id(self) -> int:
        return SPEAKERS[self.speaker][0]

    @property
    def lang_id(self) -> int:
        return LANGUAGES[self.language]

    @property
    def text_ids(self) -> list[int]:
        return WordTokenizer().encode(self.text)


def lengths(mix: dict) -> list[int]:
    """The block's frame counts: ``strata`` evenly spaced over ``frames``."""
    lo, hi = mix["frames"]
    n = mix["strata"]
    return [int(round(lo + (hi - lo) * (j + 0.5) / n)) for j in range(n)]


def text_tokens(mix: dict, frames: int) -> int:
    lo, hi = mix["frames"]
    tlo, thi = mix["text_tokens"]
    return int(round(tlo + (thi - tlo) * (frames - lo) / max(hi - lo, 1)))


def words(rng: np.random.Generator, n: int) -> str:
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


class Plan:
    """The endless sequence of requests of a mix and a seed: block after
    block of the mix's lengths, each block in an order drawn from the seed."""

    def __init__(self, mix: dict, seed: int):
        if mix.get("clients", 1) != 1 or mix.get("loop", "closed") != "closed":
            raise ValueError("the generator drives one client in a closed loop")
        self.mix = mix
        self.rng = np.random.default_rng(seed)
        self.block = lengths(mix)
        self.speakers = list(SPEAKERS)
        self.queue: list[int] = []
        self.issued = 0

    def next(self) -> Request:
        if not self.queue:
            self.queue = [self.block[j] for j in self.rng.permutation(len(self.block))]
        frames = self.queue.pop(0)
        i = self.issued
        self.issued += 1
        speaker = self.speakers[i % len(self.speakers)]
        return Request(i, frames, words(self.rng, text_tokens(self.mix, frames)), speaker, SPEAKERS[speaker][1],
                       i % self.mix["greedy_every"] == 0, int(self.rng.integers(0, 2**31 - 1)))


def warmup(mix: dict, seed: int) -> list[Request]:
    """Set-up's requests: each of the mix's warm-up sizes once sampled and
    once greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for frames, tokens in mix["warmup"]:
        for greedy in (False, True):
            out.append(Request(-1, frames, words(rng, tokens), "ryan", "english", greedy, len(out)))
    return out
