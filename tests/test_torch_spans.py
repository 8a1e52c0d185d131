"""The port's spans (``profiling.annotate``) on its batch-1 path (CPU).

On the tiny Base model of ``test_torch_voice_clone.py``:

* a stream's and an utterance's spans nest as the path runs them
  (``q3.open`` > ``q3.prefill``; ``q3.chunk`` or ``q3.audio`` > ``q3.loop``,
  ``q3.vocoder``, ``q3.grow``, ``q3.wait``), each inside its parent's time,
  and all carry the request id ``q3.open`` drew;
* an in-context clone's prompt records ``q3.clone_prompt`` >
  ``q3.speaker_encoder``, ``q3.speech_encoder`` (each read in a ``q3.wait``),
  and its stream feeds the reference codes under ``q3.prefix`` > one
  ``q3.piece`` a ``prefix_piece_sizes`` piece > ``q3.vocoder``;
* ``q3.loop``'s ``iterations`` are the frames the host launched;
* with nothing recording, a span enters no ``record_function``, runs no
  tensor operation and records nothing;
* under ``torch.profiler`` every span is a ``user_annotation`` of the trace,
  its recorded start within 0.5 ms of the event's;
* every host read ``TransferAudit`` counts in a stream lies in a
  ``q3.wait``;
* codes and audio are bit-equal with spans on and off.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qwen3_tts_tpu_torch import encoder_fixture, pipeline, profiling
from qwen3_tts_tpu_torch.audio.io import AudioBuffer
from qwen3_tts_tpu_torch.pipeline import SynthesisOptions
from qwen3_tts_tpu_torch.profiling import TransferAudit
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

TEXT = "Hello there, a few words."
# Children each span may have on the batch-1 path.
CHILDREN = {
    None: {"q3.open", "q3.chunk", "q3.audio", "q3.clone_prompt"},
    "q3.open": {"q3.prefill"},
    "q3.prefill": set(),
    "q3.chunk": {"q3.loop", "q3.vocoder", "q3.grow", "q3.wait", "q3.prefix"},
    "q3.audio": {"q3.loop", "q3.vocoder", "q3.grow", "q3.wait", "q3.prefix"},
    "q3.loop": {"q3.wait"},
    "q3.vocoder": {"q3.wait"},
    "q3.grow": set(),
    "q3.wait": set(),
    "q3.clone_prompt": {"q3.speaker_encoder", "q3.speech_encoder"},
    "q3.speaker_encoder": {"q3.wait"},
    "q3.speech_encoder": {"q3.wait"},
    "q3.prefix": {"q3.piece"},
    "q3.piece": {"q3.vocoder"},
}
REF_TEXT = "A short reference line."


@pytest.fixture(scope="module")
def model():
    return build_models()[1]


def _options(frames: int, **kw) -> SynthesisOptions:
    return SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=3, **kw)


def _stream(model, frames: int = 24):
    """(the session, its chunks' samples)."""
    session = model.synthesize_streaming(TEXT, "ryan", "english", _options(frames))
    return session, [c.samples for c in session]


def _utterance(model, frames: int = 24):
    kept = {}
    inner = model._custom_voice_session

    def keep(*args, **kwargs):
        kept["session"] = inner(*args, **kwargs)
        return kept["session"]

    model._custom_voice_session = keep
    try:
        audio = model.synthesize_with_voice(TEXT, "ryan", "english", _options(frames)).samples
    finally:
        del model._custom_voice_session
    return kept["session"], [audio]


def _clone_stream(model, seconds: float = 1.2, frames: int = 12):
    """(the clip, the in-context clone prompt, the session, its chunks' samples)."""
    clip = encoder_fixture.reference_audio(24000, seed=5, seconds=seconds)
    prompt = model.create_voice_clone_prompt(AudioBuffer(clip, 24000), REF_TEXT)
    session = model.synthesize_voice_clone_streaming(TEXT, prompt, "english", _options(frames))
    return clip, prompt, session, [c.samples for c in session]


def _check_tree(spans: list) -> None:
    """One request id; each span's parent allowed and around it in time."""
    assert {s.request for s in spans} == {spans[0].request} and spans[0].request is not None
    _check_nesting(spans)


def _check_nesting(spans: list) -> None:
    """Each span's parent allowed and around it in time."""
    for s in spans:
        parent = s.parent.name if s.parent is not None else None
        assert s.name in CHILDREN[parent], (parent, s.name)
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns, s


def test_stream_spans_nest_and_share_a_request(model, monkeypatch):
    # A 64-frame first buffer, so that the stream's 70 frames grow it once.
    monkeypatch.setattr(pipeline, "GROWTH_INITIAL_FRAMES", 64)
    with profiling.spans() as spans:
        session, chunks = _stream(model, frames=70)
    _check_tree(spans)
    names = [s.name for s in spans]
    assert names.count("q3.open") == 1 and names.count("q3.prefill") == 1
    assert names.count("q3.chunk") == len(chunks) == 8  # 4 frames, then 10 a chunk
    assert names.count("q3.grow") == 1
    assert names.count("q3.vocoder") >= len(chunks) and "q3.wait" in names
    assert session.request == spans[0].request


def test_utterance_spans_nest_and_share_a_request(model):
    with profiling.spans() as spans:
        _utterance(model)
    _check_tree(spans)
    tops = [s.name for s in spans if s.parent is None]
    assert tops == ["q3.open", "q3.audio"]
    assert {"q3.loop", "q3.vocoder", "q3.wait"} <= {s.name for s in spans}


def _under(span, name: str) -> bool:
    while span is not None:
        if span.name == name:
            return True
        span = span.parent
    return False


def test_clone_stream_spans_nest_and_count(model):
    with profiling.spans() as spans:
        clip, prompt, session, chunks = _clone_stream(model)
    clone = [s for s in spans if _under(s, "q3.clone_prompt")]
    _check_nesting(clone)
    _check_tree([s for s in spans if not _under(s, "q3.clone_prompt")])
    (top,) = [s for s in clone if s.name == "q3.clone_prompt"]
    assert top.parent is None and top.counters == {"samples": len(clip), "icl": 1}
    encoders = {s.name: s for s in clone if s.parent is top}
    assert set(encoders) == {"q3.speaker_encoder", "q3.speech_encoder"}
    n = len(prompt.ref_codes)
    assert encoders["q3.speech_encoder"].counters == {"frames": n}
    for enc in encoders.values():
        assert [s.name for s in clone if s.parent is enc] == ["q3.wait"]
    (prefix,) = [s for s in spans if s.name == "q3.prefix"]
    sizes = pipeline.prefix_piece_sizes(n, 4)  # the first chunk's 4 frames
    assert len(sizes) > 4 and sizes[-1] < 4  # whole pieces, then a binary split of the rest
    assert prefix.parent.name == "q3.chunk" and prefix.request == session.request
    assert prefix.counters == {"pieces": len(sizes), "frames": n}
    pieces = [s for s in spans if s.parent is prefix]
    assert [s.name for s in pieces] == ["q3.piece"] * len(sizes)
    assert [s.counters["frames"] for s in pieces] == sizes and sum(sizes) == n
    for piece in pieces:
        assert [s.name for s in spans if s.parent is piece] == ["q3.vocoder"]
    assert chunks


def test_clone_prompt_off_records_nothing(model, monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name) or real(name))
    clip = encoder_fixture.reference_audio(24000, seed=5, seconds=1.2)
    before = len(profiling.recorded_spans())
    off = model.create_voice_clone_prompt(AudioBuffer(clip, 24000), REF_TEXT)
    assert entered == [] and len(profiling.recorded_spans()) == before
    with profiling.spans() as spans:
        on = model.create_voice_clone_prompt(AudioBuffer(clip, 24000), REF_TEXT)
    assert len(spans) == 5 and entered == []
    assert np.array_equal(on.speaker_embedding, off.speaker_embedding)
    assert np.array_equal(on.ref_codes, off.ref_codes) and on.ref_text_ids == off.ref_text_ids


def test_two_sessions_two_requests(model):
    with profiling.spans() as spans:
        _stream(model, frames=8)
        _stream(model, frames=8)
    assert len({s.request for s in spans}) == 2


@pytest.mark.parametrize("run", [_stream, _utterance])
def test_loop_iterations_are_the_frames_launched(model, run):
    with profiling.spans() as spans:
        session, _ = run(model, 30)
    loops = [s for s in spans if s.name == "q3.loop"]
    assert loops and all(s.counters["iterations"] >= 0 for s in loops)
    assert sum(s.counters["iterations"] for s in loops) == session.state.steps >= 30


class _Ops(TorchDispatchMode):
    """Counts the tensor operations run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_enters_no_region(model, monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name) or real(name))
    before = len(profiling.recorded_spans())
    _, chunks = _stream(model)
    _utterance(model)
    assert chunks and entered == [] and len(profiling.recorded_spans()) == before
    assert profiling.annotate("q3.loop") is profiling.annotate("q3.wait", 7)  # the one do-nothing span
    with _Ops() as ops, TransferAudit() as audit:
        with profiling.annotate("q3.loop") as span:
            span.set("iterations", 3)
    assert ops.ops == 0 and audit.transfers == 0


def test_off_records_inside_spans_without_a_region(model, monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name) or real(name))
    with profiling.spans() as spans:
        _stream(model, frames=8)
    assert spans and entered == []


def _annotations(prof) -> dict:
    """{name: sorted starts, ns} of the trace's q3. user annotations."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("q3.") and e.device_type() == torch.autograd.DeviceType.CPU:
            assert e.activity_type() == "user_annotation", (e.name(), e.activity_type())
            out.setdefault(e.name(), []).append(e.start_ns())
    return {k: sorted(v) for k, v in out.items()}


def test_spans_are_the_profilers_annotations(model):
    before = len(profiling.recorded_spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _stream(model, frames=16)
        _utterance(model, frames=16)
    spans = profiling.recorded_spans()[before:]
    assert len(spans) > 20
    events = _annotations(prof)
    mine: dict = {}
    for s in spans:
        mine.setdefault(s.name, []).append(s.start_ns)
    assert set(mine) == set(events) and set(mine) >= {"q3.open", "q3.prefill", "q3.loop", "q3.vocoder", "q3.wait"}
    for name, starts in mine.items():
        assert len(starts) == len(events[name]), name
        gaps = np.abs(np.array(sorted(starts)) - np.array(events[name]))
        assert gaps.max() < 500_000, (name, gaps.max())


class _WhereAudit(TransferAudit):
    """A ``TransferAudit`` that keeps the innermost open span of each read."""

    def __init__(self):
        super().__init__()
        self.where: list = []

    def _hook(self, name, orig):
        counted = super()._hook(name, orig)

        def hook(t, *args, **kwargs):
            before = self.transfers
            out = counted(t, *args, **kwargs)
            if self.transfers > before:
                stack = profiling._open_spans()
                self.where.append(stack[-1].name if stack else None)
            return out

        return hook


@pytest.mark.parametrize("run", [_stream, _utterance])
def test_every_host_read_is_inside_a_wait(model, run):
    with profiling.spans(), _WhereAudit() as audit:
        run(model, 30)
    assert audit.transfers > 0 and audit.where == ["q3.wait"] * audit.transfers


@pytest.mark.parametrize("run", [_stream, _utterance])
def test_codes_and_audio_equal_with_spans_on_and_off(model, run):
    off_session, off_audio = run(model)
    with profiling.spans():
        on_session, on_audio = run(model)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced_session, traced_audio = run(model)
    for session, audio in ((on_session, on_audio), (traced_session, traced_audio)):
        assert torch.equal(session.state.frames, off_session.state.frames)
        assert len(audio) == len(off_audio)
        for a, b in zip(audio, off_audio):
            assert np.array_equal(a, b)
