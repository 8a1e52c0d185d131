"""The dp replicas of a sharded batch advance in lock-step (CPU, f32).

``Qwen3TTS._run_batch_loops`` runs a group's dp replicas through
``core.generate_frames_replicas``, the counterpart of the JAX package's one
program over dp: a round launches one frame of every replica still in, in
replica order (``core.batch_frame``), and the group looks at the device once
on entry and every ``core.DONE_READ_EVERY`` (N) rounds. On meshes of CPU
ranks (``make_mesh(["cpu"] * n, tp=...)``) and the models of
``test_torch_batch.eos_models`` (the four ``EOS_TEXTS`` in the voices of
``test_torch_frame_loop.SPEAKERS`` end at frames 11, 16, 8 and 3 greedy):

* the launches alternate by round at dp = 2 and 3;
* every stream's frames and frame count are bit-equal to the unsharded
  batch's, at dp = 2 and 3 and tp = 1 and 2, greedy and under seeded PCG;
* a replica whose streams end early leaves the rounds after its look, with
  at most 2N - 1 frozen frames (N - 1 with the CPU's read at the boundary),
  while the others go on;
* ``until`` is asked once a round, before any replica launches: a cut after
  k rounds leaves every replica at ``steps == k``, and resuming gives the
  frames of an uncut run;
* a dp = 2 loop makes at most ceil(frames / N) + 2 host reads, the bound of
  one replica (``tests/test_torch_profiling.py``);
* ``StreamingBatchSession`` at dp = 2 gives the same chunks at lookahead 0
  and 1, also with the chunks queued ahead cut short
  (``test_torch_lookahead.FiresAfter``): a cut chunk leaves every replica
  at the same ``steps``, and every stream still live in a replica has made
  that replica's ``steps`` frames after every call.

The order, ``until`` and host-read tests fail where the replicas' loops run
one after another.
"""

import math

import numpy as np
import pytest
import torch

import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu_torch.generation import core
from qwen3_tts_tpu_torch.parallel import sharding as S
from qwen3_tts_tpu_torch.profiling import count_host_transfers
from test_torch_batch import EOS_TEXTS, eos_models
from test_torch_frame_loop import SPEAKERS
from test_torch_lookahead import FiresAfter
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

MAX = 16
SEED = 7
N = core.DONE_READ_EVERY
TEMPERATURES = pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])


class LaggedGroupReader:
    """``core._FlagReader`` as the card runs it, on the CPU: a look returns
    each flag as it was at the previous look (False at the first)."""

    def __init__(self, devs):
        self.prev = None

    def read(self, flags):
        if isinstance(flags, torch.Tensor):
            return self.read([flags])[0]
        prev, self.prev = self.prev, [None if f is None else f.clone() for f in flags]
        return [False] * len(flags) if prev is None else [p is not None and bool(p) for p in prev]


@pytest.fixture(scope="module")
def model():
    return eos_models(build_models())[1]


def _copy(tm, dp: int = 1, tp: int = 1) -> TP.Qwen3TTS:
    """A model on ``tm``'s trees, sharded over dp x tp CPU ranks (unsharded at 1 x 1)."""
    m = TP.Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                    vocoder_config=tm.vocoder_config)
    return m.shard(S.make_mesh(["cpu"] * (dp * tp), tp=tp)) if dp * tp > 1 else m


def _group(m, b: int, **kw) -> TP.BatchGroup:
    opts = m._normalize_options(TP.SynthesisOptions(**{"max_length": MAX, "seed": SEED, "temperature": 0.0, **kw}))
    return m._prepare_batch_group("basic", EOS_TEXTS[:b], SPEAKERS[:b], ["english"] * b, [None] * b, opts,
                                  [SEED + i for i in range(b)])


def _result(group) -> tuple[np.ndarray, np.ndarray]:
    """(frames [B, max_new, 16], counts [B]) over every replica, in stream order."""
    return (np.concatenate([g.state.frames.numpy() for g in group.shards]),
            np.concatenate([g.state.frame_idx.numpy() for g in group.shards]))


def _assert_same(got: tuple, want: tuple) -> None:
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.fixture(scope="module")
def unsharded(model):
    """The unsharded batch's (frames, counts), by (b, temperature)."""
    made = {}

    def get(b: int, temperature: float = 0.0, **kw):
        key = (b, temperature, tuple(sorted(kw.items())))
        if key not in made:
            m = _copy(model)
            g = _group(m, b, temperature=temperature, **kw)
            m._run_batch_loops(g, g.frame_limits)
            made[key] = _result(g)
        return made[key]

    return get


@pytest.mark.parametrize("dp", [2, 3])
def test_launches_alternate_by_round(model, unsharded, monkeypatch, dp):
    want = unsharded(dp, min_new_tokens=MAX)
    sh = _copy(model, dp)
    group = _group(sh, dp, min_new_tokens=MAX)
    replica = {id(g.state): r for r, g in enumerate(group.shards)}
    order = []
    frame = core.batch_frame

    def recorded(run):
        order.append((replica[id(run.state)], run.state.steps))
        frame(run)

    monkeypatch.setattr(core, "batch_frame", recorded)
    sh._run_batch_loops(group, group.frame_limits)
    assert order == [(r, step) for step in range(MAX) for r in range(dp)]
    _assert_same(_result(group), want)


@TEMPERATURES
@pytest.mark.parametrize("dp,tp", [(2, 1), (3, 1), (2, 2), (3, 2)])
def test_frames_equal_unsharded(model, unsharded, dp, tp, temperature):
    b = 4 if dp == 2 else 3
    sh = _copy(model, dp, tp)
    group = _group(sh, b, temperature=temperature)
    assert [g.replica for g in group.shards] == list(range(dp))
    frames, counts = sh._generate_batch_group(group)
    want_frames, want_counts = unsharded(b, temperature)
    np.testing.assert_array_equal(counts, want_counts)
    for f, w in zip(frames, want_frames):
        np.testing.assert_array_equal(f, w)


@pytest.fixture(params=["boundary", "lagged"])
def frozen_bound(request, monkeypatch):
    """The most frozen frames past a replica's last EOS the reader allows."""
    if request.param == "lagged":
        monkeypatch.setattr(core, "_FlagReader", LaggedGroupReader)
        return 2 * N - 1
    return N - 1


def test_replica_ending_early_leaves(model, unsharded, frozen_bound):
    sh = _copy(model, 2)
    group = _group(sh, 4)
    sh._run_batch_loops(group, group.frame_limits)
    _assert_same(_result(group), unsharded(4))
    ends = [int(g.state.frame_idx.max()) for g in group.shards]
    steps = [g.state.steps for g in group.shards]
    assert ends == [16, 8]  # replica 1's streams end at frames 8 and 3
    assert all(g.state.done.all() for g in group.shards[1:])
    assert steps[0] == MAX and steps[1] < MAX
    assert steps[1] - ends[1] <= frozen_bound, (steps, ends)


class CutAfter:
    """An ``until`` that lets ``k`` rounds launch, then cuts for good."""

    def __init__(self, k: int):
        self.left, self.cut = k, False

    def __call__(self) -> bool:
        self.cut = self.cut or self.left <= 0
        self.left -= 1
        return self.cut


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("dp", [2, 3])
def test_until_cuts_every_replica_at_one_step(model, unsharded, dp, k):
    b = 4 if dp == 2 else 3
    sh = _copy(model, dp)
    group = _group(sh, b)
    sh._run_batch_loops(group, group.frame_limits, CutAfter(k))
    assert [g.state.steps for g in group.shards] == [k] * dp
    sh._run_batch_loops(group, group.frame_limits)
    _assert_same(_result(group), unsharded(b))


@pytest.mark.parametrize("frames", [12, 40])
def test_group_reads_once_every_n_rounds(model, frames):
    sh = _copy(model, 2)
    group = _group(sh, 4, max_length=frames, min_new_tokens=frames)
    _, reads = count_host_transfers(sh._run_batch_loops, group, group.frame_limits)
    assert [g.state.steps for g in group.shards] == [frames] * 2
    assert all(g.state.frame_idx.tolist() == [frames] * 2 for g in group.shards)
    assert reads <= math.ceil(frames / N) + 2, reads


def _chunks(sh, lookahead: int, check) -> list:
    opts = TP.SynthesisOptions(max_length=MAX, seed=SEED, temperature=0.0, chunk_frames=3, first_chunk_frames=2,
                               streaming_lookahead=lookahead)
    session = sh.synthesize_streaming_batch(EOS_TEXTS, SPEAKERS, options=opts)
    rounds = []
    while (chunks := session.next_chunks()) is not None:
        rounds.append([None if c is None else c.samples for c in chunks])
        check(session)
    return rounds


def _check_replicas(session) -> None:
    """Every stream still live in a replica has made its ``steps`` frames;
    a chunk queued ahead and cut leaves level every replica with a stream
    not done (one whose streams are all done may have left at a look
    before, and runs frozen frames from where it stopped)."""
    at = 0
    for g in session.group.shards:
        st, limits = g.state, torch.tensor(session.group.frame_limits[at:at + g.batch])
        live = ~st.done & (st.frame_idx < limits)
        assert (st.frame_idx[live] == st.steps).all(), (st.steps, st.frame_idx.tolist())
        at += g.batch
    if session._pending and session._pending[-1][3] is None:
        steps = {g.state.steps for g in session.group.shards if not g.state.done.all()}
        assert len(steps) <= 1, [g.state.steps for g in session.group.shards]


@pytest.mark.parametrize("after", [None, 0, 3])
def test_streaming_batch_lookahead_at_dp2(model, monkeypatch, after):
    sh = _copy(model, 2)
    want = _chunks(sh, 0, _check_replicas)
    if after is not None:
        monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(after))
    got = _chunks(sh, 1, _check_replicas)
    assert len(got) == len(want) and any(c is None for rnd in got for c in rnd)
    for g_round, w_round in zip(got, want):
        for g, w in zip(g_round, w_round):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
