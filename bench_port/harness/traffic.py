"""One general generator of requests from a traffic mix's parameters and a seed.

A mix file (``bench_port/traffic/<mix>.json``) gives:

* ``entry``: ``utterance`` (one call that returns the audio) or ``stream``
  (a session pulled chunk by chunk);
* ``prompt``: the prompt layout, ``preset`` (the default: a CustomVoice
  model's preset speakers, ``synthesize_with_voice`` /
  ``synthesize_streaming``), ``xvector`` or ``icl`` (a Base model's clone of a
  reference clip: its x-vector alone, or in context with the clip's codes
  and transcript; ``synthesize_voice_clone`` / ``_streaming``) or
  ``design`` (a VoiceDesign model's voice described in words;
  ``synthesize_voice_design`` / ``_streaming``);
* ``frames``: [lo, hi], the codec frames a request is forced to (12.5 a
  second of audio), and ``strata``: how many evenly spaced lengths a block
  of requests holds. Every seed gets the same lengths in each block, in its
  own order, so seeds change the order of the work and not its amount;
* ``text_tokens``: [lo, hi], the text's length, rising with the frames;
* ``temperature``, and ``greedy_every``: every k-th request (the first among
  them) is greedy with no repetition penalty asked for (an in-context clone
  runs under the program's least penalty all the same), so that the check
  can judge its codes against the reference;
* for streams: ``streaming_lookahead``, ``chunk_frames``, ``first_chunk_frames``;
* ``warmup``: [[frames, text tokens], ...], the requests set-up runs, one
  sampled and one greedy of each;
* ``check_requests``: how many greedy requests the check judges, the longest
  among them;
* for clones: ``voices``, how many reference voices are drawn from the seed
  (greedy and sampled requests each take them in turn); ``ref_seconds``,
  [lo, hi], their clips' lengths, evenly spaced over the voices in the
  seed's order;
  ``ref_text_tokens``, [lo, hi], their transcripts' lengths, rising with
  the clips'; ``clone_prompt``, ``per_request`` (the clone prompt is made
  from the clip inside every request, as a one-shot clone API does) or
  ``per_voice`` (once a voice, in set-up); ``icl_sequential``: the
  in-context layout puts the text before the codes instead of over them;
* for descriptions: ``instruct_tokens``, [lo, hi], the description's words,
  a block's requests evenly spaced over them in the seed's order.

A key that is absent leaves the requests as they were before it existed,
drawn in the same order. Preset speakers are the nine presets, taken in
turn, each in its own language; clones and descriptions speak English. The
loop is closed with one client (``"clients": 1``, ``"loop": "closed"``): the
next request is sent when the last one has returned.
"""

from __future__ import annotations

import math
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
PROMPTS = ("preset", "xvector", "icl", "design")
CLONES = ("xvector", "icl")
SAMPLE_RATE = 24000
# An in-context clone's frames are capped at max(ICL_MIN_FRAMES,
# ICL_FRAMES_PER_TOKEN x its text tokens) by the program.
ICL_MIN_FRAMES, ICL_FRAMES_PER_TOKEN = 75, 6

WORDS = ("the voice of a reader carries each line across the room while the river keeps its slow time under "
         "bridges and lamps of an old town where people gather to listen talk and wait for news from far away "
         "places that nobody here has seen").split()


class WordTokenizer:
    """One token a word. A frozen copy of ``WordTokenizer`` in
    ``qwen3_tts_tpu_torch/synthesis_timing.py``: the published Qwen2
    vocabulary is not in the repository."""

    def encode(self, text: str) -> list[int]:
        return [200 + (sum(map(ord, w)) * 37) % 1000 for w in text.split()]


def instruct_ids(instruct: str) -> list[int]:
    """A voice description's token ids as the model reads them: its ChatML
    user turn."""
    return WordTokenizer().encode(f"<|im_start|>user\n{instruct}<|im_end|>\n")


@dataclass(frozen=True)
class Voice:
    """A reference voice of a clone: its clip (24 kHz float32) and transcript."""

    index: int
    samples: np.ndarray
    ref_text: str

    @property
    def ref_text_ids(self) -> list[int]:
        return WordTokenizer().encode(self.ref_text)


@dataclass(frozen=True)
class Request:
    index: int
    frames: int
    text: str
    speaker: str
    language: str
    greedy: bool
    seed: int
    prompt: str = "preset"
    voice: int | None = None  # a clone's voice (``voices``)
    instruct: str | None = None  # a description's words

    @property
    def speaker_id(self) -> int:
        return SPEAKERS[self.speaker][0]

    @property
    def lang_id(self) -> int:
        return LANGUAGES[self.language]

    @property
    def text_ids(self) -> list[int]:
        return WordTokenizer().encode(self.text)


def spread(lo_hi, n: int) -> list[float]:
    """``n`` values evenly spaced over [lo, hi], each in the middle of its share."""
    lo, hi = lo_hi
    return [lo + (hi - lo) * (j + 0.5) / n for j in range(n)]


def lengths(mix: dict) -> list[int]:
    """The block's frame counts: ``strata`` evenly spaced over ``frames``."""
    return [int(round(x)) for x in spread(mix["frames"], mix["strata"])]


def text_tokens(mix: dict, frames: int) -> int:
    lo, hi = mix["frames"]
    tlo, thi = mix["text_tokens"]
    return int(round(tlo + (thi - tlo) * (frames - lo) / max(hi - lo, 1)))


def words(rng: np.random.Generator, n: int) -> str:
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


def check_mix(mix: dict) -> None:
    """Refuse a mix the program cannot serve as asked: an unknown layout, a
    clone with no voices, or an in-context clone whose frames exceed the
    program's cap of max(75, 6 x text tokens), which would end it early."""
    prompt = mix.get("prompt", "preset")
    if prompt not in PROMPTS:
        raise ValueError(f"prompt {prompt!r} is none of {PROMPTS}")
    if prompt in CLONES and mix.get("voices", 0) < 1:
        raise ValueError("a clone's mix needs one voice or more")
    if prompt == "icl":
        sizes = [(f, text_tokens(mix, f)) for f in lengths(mix)] + [tuple(w) for w in mix["warmup"]]
        over = [(f, t) for f, t in sizes if f > max(ICL_MIN_FRAMES, ICL_FRAMES_PER_TOKEN * t)]
        if over:
            raise ValueError(f"in-context clones of (frames, text tokens) {over} exceed the program's cap of "
                             f"max({ICL_MIN_FRAMES}, {ICL_FRAMES_PER_TOKEN} x text tokens)")


def speech_like(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """A clip that stands in for a recorded voice: syllables of 0.12-0.30 s
    with pauses of 0.04-0.20 s between them, each a sine envelope over a
    glottal-like tone (12 harmonics falling as 1/k) whose pitch glides about
    the voice's own (90-240 Hz), breath noise 30 dB below it, scaled to an
    RMS of 0.08 (-22 dBFS, a voice recorded at a normal level), float32."""
    n = int(round(seconds * SAMPLE_RATE))
    base = rng.uniform(90.0, 240.0)
    env, f0, at = np.zeros(n), np.full(n, base), 0
    while at < n:
        size = int(rng.uniform(0.12, 0.30) * SAMPLE_RATE)
        seg = slice(at, min(at + size, n))
        m = seg.stop - seg.start
        env[seg] = np.sin(np.pi * np.arange(m) / size)
        f0[seg] = base * 2.0 ** (rng.uniform(-0.25, 0.25) + rng.uniform(-0.15, 0.15) * np.arange(m) / size)
        at += size + int(rng.uniform(0.04, 0.20) * SAMPLE_RATE)
    phase = 2.0 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    tone = sum(np.sin(k * phase) / k for k in range(1, 13))
    x = env * tone + 10 ** (-30 / 20) * rng.standard_normal(n) * np.sqrt(np.mean((env * tone) ** 2))
    return (0.08 * x / np.sqrt(np.mean(x ** 2))).astype(np.float32)


def voices(mix: dict, seed: int) -> list[Voice]:
    """A clone mix's reference voices, drawn from the seed apart from the
    requests; [] for any other mix."""
    if mix.get("prompt", "preset") not in CLONES:
        return []
    rng = np.random.default_rng([seed, 1])
    n = mix["voices"]
    seconds = spread(mix["ref_seconds"], n)
    order = rng.permutation(n)
    (slo, shi), (tlo, thi) = mix["ref_seconds"], mix["ref_text_tokens"]
    out = []
    for v in range(n):
        s = seconds[order[v]]
        tokens = int(round(tlo + (thi - tlo) * (s - slo) / max(shi - slo, 1e-9)))
        out.append(Voice(v, speech_like(rng, s), words(rng, tokens)))
    return out


class Plan:
    """The endless sequence of requests of a mix and a seed: block after
    block of the mix's lengths, each block in an order drawn from the seed."""

    def __init__(self, mix: dict, seed: int):
        if mix.get("clients", 1) != 1 or mix.get("loop", "closed") != "closed":
            raise ValueError("the generator drives one client in a closed loop")
        check_mix(mix)
        self.mix = mix
        self.prompt = mix.get("prompt", "preset")
        self.rng = np.random.default_rng(seed)
        self.block = lengths(mix)
        self.speakers = list(SPEAKERS)
        self.queue: list[int] = []
        self.issued = 0
        # A clone's greedy and sampled requests each take the voices in turn,
        # so that the check's greedy ones meet every voice.
        self.turns = {True: 0, False: 0}
        # A description's lengths come from a stream of their own.
        self.instruct_rng = np.random.default_rng([seed, 2])
        self.instructs: list[int] = []

    def next(self) -> Request:
        if not self.queue:
            self.queue = [self.block[j] for j in self.rng.permutation(len(self.block))]
        frames = self.queue.pop(0)
        i = self.issued
        self.issued += 1
        text = words(self.rng, text_tokens(self.mix, frames))
        greedy = i % self.mix["greedy_every"] == 0
        seed = int(self.rng.integers(0, 2**31 - 1))
        if self.prompt == "preset":
            speaker = self.speakers[i % len(self.speakers)]
            return Request(i, frames, text, speaker, SPEAKERS[speaker][1], greedy, seed)
        voice = None
        if self.prompt in CLONES:
            voice = self.turns[greedy] % self.mix["voices"]
            self.turns[greedy] += 1
        instruct = None
        if self.prompt == "design":
            if not self.instructs:
                sizes = spread(self.mix["instruct_tokens"], self.mix["strata"])
                self.instructs = [int(round(sizes[j])) for j in self.instruct_rng.permutation(len(sizes))]
            instruct = words(self.instruct_rng, self.instructs.pop(0))
        return Request(i, frames, text, "", "english", greedy, seed, self.prompt, voice, instruct)


def warmup(mix: dict, seed: int) -> list[Request]:
    """Set-up's requests: each of the mix's warm-up sizes once sampled and
    once greedy (a clone's in turn over its voices, a description at the
    mix's longest)."""
    rng = np.random.default_rng(seed)
    prompt, out = mix.get("prompt", "preset"), []
    for frames, tokens in mix["warmup"]:
        for greedy in (False, True):
            text = words(rng, tokens)
            if prompt == "preset":
                out.append(Request(-1, frames, text, "ryan", "english", greedy, len(out)))
                continue
            voice = len(out) % mix["voices"] if prompt in CLONES else None
            instruct = words(rng, math.ceil(mix["instruct_tokens"][1])) if prompt == "design" else None
            out.append(Request(-1, frames, text, "", "english", greedy, len(out), prompt, voice, instruct))
    return out
