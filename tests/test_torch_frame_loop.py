"""The frame loops' contract, the port against the JAX package (f32, CPU).

``core.generate_frames`` and ``core.generate_frames_batch`` keep ``done``
and the frame counts on the device, freeze a stream that is done (or at its
limit) by a device-side select, and let the host look at the device only
every ``core.DONE_READ_EVERY`` iterations. On the models of
``test_torch_batch.eos_models`` (the codec head's EOS column scaled, so that
the four ``EOS_TEXTS``, each in its own preset voice, end at different
frames), greedy and under seeded PCG sampling:

* each loop's final state (the whole frames buffer, the tokens, the frame
  counts, ``done``) equals the JAX package's ``GenState`` after its
  ``while_loop`` (batch 1: the session's ``_advance``; B = 4: the vmapped
  ``generate_frames_batch``);
* the frozen iterations past EOS number at most ``2N - 1`` a loop call (N =
  ``DONE_READ_EVERY``; ``N`` in a call entered already done), and ``N - 1``
  (none in a call entered done) with the CPU's read at the boundary;
* no frame row past a stream's EOS reaches an output (the buffer's rows past
  the count stay zero; ``synthesize_with_voice`` and ``synthesize_batch``
  give the JAX package's audio length and samples);
* re-entry at a raised frame limit gives the JAX package's state.

Every case runs twice: with the CPU's reader, and with ``LaggedReader``,
which returns the flag one look late as the card's pinned-copy reader does
(the card's reader itself needs CUDA: ``chip_smoke.py`` phase ``loop``).
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.generation import batch as jbatch
from qwen3_tts_tpu_torch.generation import core
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.pipeline import SynthesisOptions
from test_torch_batch import EOS_TEXTS, eos_models
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

MAX = 16
SEED = 7  # stream i takes seed 7 + i (tests/test_streaming_batch.py's uneven-EOS case)
# Stream i speaks as SPEAKERS[i]: greedy decoding ends these at frames 11, 16, 8 and 3 (the text alone moves
# no EOS of the tiny model), PCG at 16, 16, 14 and 9.
SPEAKERS = ["vivian", "ryan", "sohee", "dylan"]
N = core.DONE_READ_EVERY
TEMPERATURES = pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])


class LaggedReader:
    """``core._FlagReader`` as the card runs it, on the CPU: a look returns
    the flag as it was at the previous look (False at the first)."""

    def __init__(self, dev):
        self.prev = None

    def read(self, flag: torch.Tensor) -> bool:
        prev, self.prev = self.prev, flag.clone()
        return prev is not None and bool(prev)


@pytest.fixture(scope="module")
def models():
    return eos_models(build_models())


@pytest.fixture(params=["boundary", "lagged"])
def reader(request, monkeypatch):
    """The most frozen iterations the reader allows a call: (past an EOS met
    in the call, in a call entered done)."""
    if request.param == "lagged":
        monkeypatch.setattr(core, "_FlagReader", LaggedReader)
        return 2 * N - 1, N
    return N - 1, 0


def _options(temperature: float, i: int, **kw) -> dict:
    return dict(max_length=MAX, seed=SEED + i, temperature=temperature, **kw)


def _sessions(models, i: int, temperature: float):
    jm, tm = models
    kw = _options(temperature, i)
    return (jm._custom_voice_session(EOS_TEXTS[i], SPEAKERS[i], "english", JP.SynthesisOptions(**kw)),
            tm._custom_voice_session(EOS_TEXTS[i], SPEAKERS[i], "english", SynthesisOptions(**kw)))


def _assert_state_equal(got, want) -> None:
    """frames (the whole buffer), tokens, frame counts and done of a port
    state against a JAX ``GenState`` (batched or not)."""
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
    np.testing.assert_array_equal(got.frame_idx.numpy(), np.asarray(want.frame_idx))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))


def _snapshot(state) -> tuple:
    return state.steps, state.frame_idx.reshape(-1).tolist(), state.done.reshape(-1).tolist()


def _check_frozen(state, before: tuple, bounds: tuple) -> None:
    """Rows past each stream's count are zero, and the call since
    ``before`` (a ``_snapshot``) ran at most ``bounds`` frozen iterations
    (``steps`` counts every one): the first bound past an EOS met in the
    call, the second when every stream was done on entry."""
    steps0, counts0, done0 = before
    frames = state.frames.numpy().reshape(-1, *state.frames.shape[-2:])
    counts, dones = _snapshot(state)[1:]
    for rows, n in zip(frames, counts):
        assert not rows[n:].any()
    if all(dones):
        frozen = state.steps - steps0 - max(n - n0 for n, n0 in zip(counts, counts0))
        assert frozen <= bounds[1 if all(done0) else 0], (state.steps, steps0, counts, counts0)


@TEMPERATURES
def test_batch1_loop_matches_jax(models, reader, temperature):
    counts = []
    for i in range(len(EOS_TEXTS)):
        js, ts = _sessions(models, i, temperature)
        js._advance(MAX)
        before = _snapshot(ts.state)
        ts._advance(MAX)
        _assert_state_equal(ts.state, js.state)
        _check_frozen(ts.state, before, reader)
        counts.append(int(ts.state.frame_idx))
        assert ts.state.pos == int(js.state.pos) + ts.state.steps - counts[-1]  # JAX stops at EOS
    assert len(set(counts)) > 1 and min(counts) < MAX, counts


@TEMPERATURES
def test_batch1_reentry_matches_jax(models, reader, temperature):
    """The loop entered at 3, 6 (past the first look) and 16 frames, and
    once more when done."""
    for i in range(len(EOS_TEXTS)):
        js, ts = _sessions(models, i, temperature)
        for limit in (3, 6, MAX, MAX):
            js._advance(limit)
            before = _snapshot(ts.state)
            ts._advance(limit)
            _assert_state_equal(ts.state, js.state)
            _check_frozen(ts.state, before, reader)


def _batch(models, temperature: float, limits: tuple, bounds: tuple):
    """Both packages' B = 4 loops over ``EOS_TEXTS``, entered once a limit;
    checks each call's frozen iterations against ``bounds``."""
    jm, tm = models
    b = len(EOS_TEXTS)
    kw = _options(temperature, 0)
    seeds = [SEED + i for i in range(b)]
    args = ("basic", EOS_TEXTS, SPEAKERS, ["english"] * b, [None] * b)
    (jstate, trailing, trailing_lens, pad, uniforms, scfg, frame_limits, _) = jm._prepare_batch_group(
        *args, jm._normalize_options(JP.SynthesisOptions(**kw)), seeds)
    g = tm._prepare_batch_group(*args, tm._normalize_options(SynthesisOptions(**kw)), seeds)
    for limit in limits:
        jstate = jbatch.generate_frames_batch(jm.talker_params, jm.cp_params, jm.config.talker,
                                              jm.config.code_predictor, scfg, jstate, trailing, trailing_lens, pad,
                                              uniforms, np.minimum(np.asarray(frame_limits), limit))
        before = _snapshot(g.state)
        core.generate_frames_batch(tm.talker_params, tm.cp_params, tm.config.talker, tm.config.code_predictor,
                                   g.scfg, g.state, g.trailing, g.trailing_lens, g.pad_embed, g.uniforms,
                                   [min(n, limit) for n in g.frame_limits])
        _check_frozen(g.state, before, bounds)
    return jstate, g.state


@TEMPERATURES
def test_batched_loop_matches_jax(models, reader, temperature):
    jstate, state = _batch(models, temperature, (MAX,), reader)
    _assert_state_equal(state, jstate)
    counts = state.frame_idx.tolist()
    assert len(set(counts)) > 1 and min(counts) < MAX, counts
    # Every live stream had made ``steps`` frames: a stream that ran to the
    # limit made all of them, and no stream made more.
    assert max(counts) <= state.steps and all(n == state.steps for n, d in zip(counts, state.done.tolist())
                                                if not d)


@TEMPERATURES
def test_batched_reentry_matches_jax(models, reader, temperature):
    jstate, state = _batch(models, temperature, (2, 5, MAX, MAX), reader)
    _assert_state_equal(state, jstate)


def test_outputs_stop_at_eos(models, reader):
    """``synthesize_with_voice`` (chunks queued ahead, some past EOS) and
    ``synthesize_batch`` end each stream at its EOS frame: the JAX package's
    samples, none from a frozen frame."""
    jm, tm = models
    kw = _options(0.9, 0)
    jopts, topts = JP.SynthesisOptions(**kw), SynthesisOptions(**kw)
    for i in (2, 3):
        seeded = dict(kw, seed=SEED + i)
        want = jm.synthesize_with_voice(EOS_TEXTS[i], SPEAKERS[i], "english", JP.SynthesisOptions(**seeded)).samples
        got = tm.synthesize_with_voice(EOS_TEXTS[i], SPEAKERS[i], "english", SynthesisOptions(**seeded)).samples
        assert got.shape == want.shape and len(got) % SAMPLES_PER_FRAME == 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = jm.synthesize_batch(EOS_TEXTS, SPEAKERS, options=jopts)
    got = tm.synthesize_batch(EOS_TEXTS, SPEAKERS, options=topts)
    assert [a.samples.shape for a in got] == [a.samples.shape for a in want]
    assert len({len(a.samples) for a in got}) > 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.samples, w.samples, rtol=0, atol=1e-5)
