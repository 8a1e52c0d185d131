"""Autoregressive generation core: the frame loop.

PyTorch port of ``qwen3_tts_tpu/generation/core.py``. Per frame:
  1. embed the current semantic token,
  2. code predictor: 15 acoustic codes (argmax; the route ``cp.cp_route``
     names: on the card one kernel call, or Jacobi iterations),
  3. store frame [semantic, acoustic x15],
  4. residual-VQ fuse: semantic embed + sum(acoustic embeds) + trailing text,
  5. talker decode step -> logits,
  6. penalties (repetition, suppression, min-new-tokens) -> sample,
  7. update the penalty mask; done := (next == EOS).

The JAX loop is one ``while_loop`` whose condition reads ``done`` on the
device. Here the host launches the iterations, and the loop keeps the JAX
carry's contract: ``done`` and the frame count stay on the device, and
once ``done`` is set the token, penalty mask, frames, frame count and last
hidden state are frozen by a device-side select (the JAX body's ``sel``),
while the cache position advances every iteration (JAX's ``pos + 1``).
The host counts the iterations it launched (``steps``), which is the frame
count of every live stream, and learns of EOS from a lagged read every
``DONE_READ_EVERY`` iterations (``_FlagReader``), so the loop never drains
the card's stream and runs at most ``2 * DONE_READ_EVERY - 1`` frozen
iterations past EOS in a call (``DONE_READ_EVERY - 1`` on the CPU, which
reads at the boundary). A call given ``until`` (a streaming session's chunk
queued ahead) takes no look: it stops when ``until`` says so or at its
frame limit, one chunk on. The Jacobi code predictor still reads once a pass
(``code_predictor.predict_acoustic_codes_jacobi``): its pass count depends
on the data.

``generate_frames`` re-enters: a streaming session calls it chunk by chunk
with a higher ``frame_limit``, on a frames buffer and a cache that may have
grown (new tensors) between calls; the uniform drawn for frame i does not
depend on the buffer's size.

``generate_frames_batch`` is the loop of B streams (the JAX package's
vmapped loop in its ``generation/batch.py``), each with its own cache position,
frame count and frame limit, re-entered the same way by a
``StreamingBatchSession``. ``generate_frames_replicas`` runs the dp
replicas of a sharded batch in lock-step, one frame of every replica a
round (``batch_frame``) and one look for the group, as the JAX package's
one program over dp does; ``generate_frames_batch`` is its one-replica
case.

Both loops take the ``mesh`` of a sharded model (``Qwen3TTS.shard``): the talker
is then one replica's ``parallel.sharding.ShardedTree`` and the cache an
``nn.TPCache``; the rest of the frame stays on the replica's first device,
which holds the flags the host reads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import profiling
from ..models import code_predictor as cp
from ..models import talker
from ..models import tokens as T
from ..models.config import CodePredictorConfig, TalkerConfig
from ..ops import nn, sampling
from ..parallel import collectives
from ..parallel.sharding import ShardedTree

# Iterations between two looks at the loop's stop flag (a loop call also
# looks on entry). A look waits for the flag copied one look earlier, so the
# host runs at most 2N - 1 frozen iterations past an EOS met in the call (N
# when the state was done on entry) and stays at most 2N - 1 iterations
# ahead of the card. 2 on an NVIDIA H100 80GB HBM3 at 700 W
# (``synthesis_timing.py --cells loop-sweep-bf16``, N from 1 to 12 on the
# 1.7B bf16 model, forward then back): the staged frame is level from N = 2
# up (4.7658-4.7712 ms; N = 1 4.7766-4.7767), the streamed TTFA shows no
# trend in N beyond its own spread, and every frozen frame past EOS costs a
# whole frame (~4.8 ms at batch 1, ~150 ms in the eager B = 8 loop): 1, 2,
# 4-5 and 20 of them at N = 1, 2, 3-4 and 12.
DONE_READ_EVERY = 2


class _FlagReader:
    """The host's view of 0-d bool device flags, taken at loop boundaries:
    one flag (``read`` gives a bool), or one a dp replica, each on its
    replica's device (``read`` of a list gives a list; a None entry is not
    looked at, and its element of the answer means nothing).

    On the card a boundary enqueues a non-blocking copy of each flag into
    its element of one of two pinned host slots and records an event on
    its device, then waits on the previous boundary's events only and reads
    that slot: no stream is drained, and the values read are one boundary
    old. On the CPU there is no stream: the flags are read at the boundary.
    Each look is one host read, whatever the number of flags."""

    def __init__(self, devs):
        self.devs = list(devs) if isinstance(devs, (list, tuple)) else [devs]
        self.lagged = self.devs[0].type == "cuda"
        self.slots = torch.zeros((2, len(self.devs)), dtype=torch.bool, pin_memory=True) if self.lagged else None
        self.events: list = [None, None]
        self.looks = 0

    def read(self, flags):
        if isinstance(flags, torch.Tensor):
            return self.read([flags])[0]
        if not self.lagged:
            with profiling.annotate("q3.wait"):
                seen = iter(torch.stack([f for f in flags if f is not None]).tolist())
            return [next(seen) if f is not None else True for f in flags]
        slot = self.looks % 2
        self.looks += 1
        events = []
        for i, (dev, flag) in enumerate(zip(self.devs, flags)):
            if flag is not None:
                with torch.cuda.device(dev):
                    self.slots[slot, i].copy_(flag, non_blocking=True)
                    events.append(torch.cuda.Event())
                    events[-1].record()
        self.events[slot] = events
        prev = self.events[1 - slot]
        if prev is None:
            return [False] * len(flags)
        with profiling.annotate("q3.wait"):
            for event in prev:
                event.synchronize()
            return self.slots[1 - slot].tolist()


def to_device(values: list[int], dev: torch.device) -> torch.Tensor:
    """Host ints as an int64 tensor on ``dev``; to a card through pinned
    memory with no host wait."""
    t = torch.tensor(values, dtype=torch.int64)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


@dataclass
class GenState:
    """Carried state of the frame loop (tensors updated in place)."""

    cache: nn.KVCache | nn.TPCache  # talker KV cache (split over tp ranks under a mesh)
    last_hidden: torch.Tensor  # [1, 1, hidden] normed talker hidden
    token: torch.Tensor  # [] int64 current semantic token
    penalty_mask: torch.Tensor  # [codec_vocab] float32
    frames: torch.Tensor  # [max_new, 16] int32
    frame_idx: torch.Tensor  # [] int64 frames generated so far (frozen once done)
    pos: int  # next talker cache write position (advances every iteration)
    done: torch.Tensor  # [] bool
    steps: int = 0  # iterations launched: the frame count until EOS, past it on frozen iterations


def init_state(
    scfg: sampling.SamplingConfig,
    prefill_logits: torch.Tensor,
    last_hidden: torch.Tensor,
    prefill_len: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
) -> GenState:
    """Sample the first semantic token from prefill logits and seed the state."""
    vocab = prefill_logits.shape[-1]
    dev = prefill_logits.device
    penalty_mask = torch.zeros((vocab,), dtype=torch.float32, device=dev)
    suppression = sampling.build_suppression_mask(vocab, scfg.eos_token_id, dev)
    logits = sampling.apply_generation_penalties(prefill_logits, penalty_mask, suppression, scfg, 0)
    token = sampling.sample(logits, scfg, uniforms[0])[0]
    penalty_mask[token.reshape(1)] = 1.0
    return GenState(
        cache=cache,
        last_hidden=last_hidden,
        token=token,
        penalty_mask=penalty_mask,
        frames=torch.zeros((max_new_tokens, T.NUM_CODE_GROUPS), dtype=torch.int32, device=dev),
        frame_idx=torch.zeros((), dtype=torch.int64, device=dev),
        pos=prefill_len,
        done=token == scfg.eos_token_id,
    )


def generate_frames(
    talker_params: dict,
    cp_params: dict,
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    state: GenState,
    trailing: torch.Tensor,  # [Tb, hidden] per-frame text additions
    trailing_len: int,
    pad_embed: torch.Tensor,  # [hidden] tts_pad addition after trailing
    uniforms: torch.Tensor,  # [max_new + 1] float32 seeded uniform stream
    frame_limit: int,
    cp_frame_pack=None,  # the code predictor's fused_layer.CpFramePack, on the card
    talker_step_pack=None,  # the talker's fused_layer.TalkerStepPack, on the card
    cp_step_pack=None,  # the code predictor's fused_layer.CpStepPack or FusedStepPack, on the card
    on_frame=None,
    mesh=None,  # parallel.sharding.Mesh of a sharded model (talker_params one replica's ShardedTree)
    tp_step_packs=None,  # the ranks' fused_layer.tp_step_packs, on the cards
    until=None,  # () -> bool: stop launching once True, with no look at done
) -> GenState:
    """Advance the loop until EOS or ``frame_limit`` frames exist (at most
    the frames buffer's rows); a state already done does not move (its
    iterations are frozen).

    The host launches iterations until ``state.steps`` reaches the limit or
    a look at ``done`` (on entry and every ``DONE_READ_EVERY`` iterations,
    lagged by one look on the card) shows EOS; the true frame count is
    ``state.frame_idx`` on the device.

    ``on_frame(idx, token, codes, logits)``, when given, is called once a
    frame with the frame's index, its semantic token, its 15 acoustic codes
    and the post-penalty logits the next token is sampled from (device
    tensors; ``generation/debug.py`` reads them); the loop then reads
    ``done`` before every frame and stops at EOS, as the debug path did.

    ``until``, when given, is called before every iteration, and the loop
    stops launching as soon as it returns True; it then takes no look at
    ``done``, so the host never waits for the card inside the call. A
    streaming session queues a chunk ahead this way and stops once the
    chunk before it is on the host (``pipeline.StreamingSession``): the
    iterations past EOS it launches are frozen, at most ``frame_limit``
    less the steps on entry.

    Under a ``mesh`` the talker is a replica's ``ShardedTree`` and the cache
    an ``nn.TPCache``: decode steps run kernels 5 and 6 on every rank
    (``talker.tp_plane_mode``, the ranks' planes taken once per call) or
    the tensor-parallel layer path, never the whole-step kernel; the code
    predictor, the sampling and the step input stay on the replica's first
    device, whose kernels launch there."""
    with profiling.annotate("q3.loop") as span:
        _check_mesh(talker_params, mesh)
        suppression = sampling.build_suppression_mask(
            state.penalty_mask.shape[0], scfg.eos_token_id, state.penalty_mask.device
        )
        max_new = state.frames.shape[0]
        # Never run past the frames buffer: iterations stop at frame_limit <=
        # max_new, so ``steps`` indexes a row of the buffer and ``pos`` stays
        # within the cache (prefill + max_new rows). A frozen iteration past EOS
        # writes its own old row back, and cache rows past the live frontier,
        # which nothing reads.
        frame_limit = min(frame_limit, max_new)
        tb = trailing.shape[0]
        # Whole-step kernel mode: take the cache's [L, S, KV*D] plane views once
        # per call (views of the same memory, written in place; a grown cache
        # is a new tensor). Under a mesh: every rank's planes, for kernels 5 + 6.
        tp_planes = talker.tp_plane_views(state.cache) if talker.tp_plane_mode(talker_params, tcfg, state.cache,
                                                                               mesh) else None
        planes = None
        if mesh is None and talker.stream_plane_mode(talker_params, tcfg, state.cache):
            planes = talker.plane_views(state.cache)
        with collectives.device_scope(state.frames.device):
            reader = _FlagReader(state.frames.device) if on_frame is None and until is None else None
            stop = reader is not None and reader.read(state.done)
            ran = 0
            while not stop and state.steps < frame_limit:
                if on_frame is not None and bool(state.done):
                    break
                if until is not None and until():
                    break
                idx = state.steps
                # A 1-element index: a 0-d index tensor is read on the host (``item``) by
                # PyTorch's indexing, a synchronising call.
                semantic_embed = talker.embed_codec(talker_params, state.token.reshape(1))[None]
                codes = cp.predict_acoustic_codes(cp_params, cpcfg, state.last_hidden, semantic_embed, cp_frame_pack,
                                                  cp_step_pack)
                frame = torch.cat([state.token.reshape(1).to(torch.int32), codes])
                done = state.done
                state.frames[idx] = torch.where(done, state.frames[idx], frame)

                acoustic_sum = cp.acoustic_embedding_sum(cp_params, codes).to(semantic_embed.dtype)
                text_add = trailing[min(idx, tb - 1)] if idx < trailing_len else pad_embed
                step_input = semantic_embed + acoustic_sum + text_add.to(semantic_embed.dtype)[None, None, :]

                if tp_planes is not None:
                    hidden, logits = talker.decode_step_planes_tp(talker_params, tcfg, step_input, state.pos,
                                                                  *tp_planes, tp_step_packs)
                elif planes is not None:
                    hidden, logits = talker.decode_step_planes(talker_params, tcfg, step_input, state.pos, *planes,
                                                               talker_step_pack)
                else:
                    hidden, logits = talker.decode_step(talker_params, tcfg, step_input, state.pos, state.cache)

                token_count = idx + 1
                logits = sampling.apply_generation_penalties(
                    logits, state.penalty_mask, suppression, scfg, token_count
                )
                next_token = sampling.sample(logits, scfg, uniforms[min(token_count, max_new)])[0]
                seen = state.penalty_mask[next_token.reshape(1)]
                state.penalty_mask.scatter_(0, next_token.reshape(1), torch.where(done, seen, torch.ones_like(seen)))
                if on_frame is not None:
                    on_frame(idx, state.token, codes, logits)

                state.last_hidden = torch.where(done, state.last_hidden, hidden)
                state.token = torch.where(done, state.token, next_token)
                state.frame_idx = state.frame_idx + ~done
                state.done = done | (next_token == scfg.eos_token_id)
                state.steps = token_count
                state.pos += 1
                ran += 1
                if reader is not None and ran % DONE_READ_EVERY == 0 and state.steps < frame_limit:
                    stop = reader.read(state.done)
        span.set("iterations", ran)
    return state


def _check_mesh(talker_params, mesh) -> None:
    if (mesh is not None) != isinstance(talker_params, ShardedTree):
        raise ValueError("a sharded talker tree runs with its model's mesh, and a mesh with a sharded tree")


# ---------------------------------------------------------------------------
# Batched frame loop (throughput mode)
# ---------------------------------------------------------------------------


@dataclass
class BatchGenState:
    """The frame loop's state for B streams (the JAX package's ``GenState``
    with a leading batch axis; tensors updated in place)."""

    cache: nn.KVCache | nn.TPCache  # [L, B, S, KV, D] (KV heads over tp ranks under a mesh)
    last_hidden: torch.Tensor  # [B, 1, hidden]
    token: torch.Tensor  # [B] int64
    penalty_mask: torch.Tensor  # [B, codec_vocab] float32
    frames: torch.Tensor  # [B, max_new, 16] int32
    frame_idx: torch.Tensor  # [B] int64 frames generated so far, a stream
    pos: torch.Tensor  # [B] int64 next talker cache write position, a stream (advances every iteration)
    done: torch.Tensor  # [B] bool
    steps: int = 0  # iterations launched: the frame count of every live stream

    @property
    def batch(self) -> int:
        return self.frames.shape[0]


def init_state_batch(
    scfg: sampling.SamplingConfig,
    prefill_logits: torch.Tensor,  # [B, vocab]
    last_hidden: torch.Tensor,  # [B, 1, hidden]
    prefill_lens: list[int],
    cache: nn.KVCache,
    uniforms: torch.Tensor,  # [B, max_new + 1]
    max_new_tokens: int,
) -> BatchGenState:
    """``init_state`` of B streams: each samples its first token with its
    own uniform ``uniforms[b, 0]``."""
    b, vocab = prefill_logits.shape
    dev = prefill_logits.device
    penalty_mask = torch.zeros((b, vocab), dtype=torch.float32, device=dev)
    suppression = sampling.build_suppression_mask(vocab, scfg.eos_token_id, dev)
    logits = sampling.apply_generation_penalties(prefill_logits, penalty_mask, suppression, scfg, 0)
    token = sampling.sample_rows(logits, scfg, uniforms[:, 0])
    penalty_mask[torch.arange(b, device=dev), token] = 1.0
    return BatchGenState(
        cache=cache,
        last_hidden=last_hidden,
        token=token,
        penalty_mask=penalty_mask,
        frames=torch.zeros((b, max_new_tokens, T.NUM_CODE_GROUPS), dtype=torch.int32, device=dev),
        frame_idx=torch.zeros((b,), dtype=torch.int64, device=dev),
        pos=to_device(list(prefill_lens), dev),
        done=token == scfg.eos_token_id,
    )


@dataclass
class ReplicaLoop:
    """One dp replica's share of a batched loop: its trees (a plain tree, or
    under a mesh the replica's ``ShardedTree`` and whole code predictor), the
    state of its streams and their inputs (``generate_frames_batch``'s)."""

    talker_params: dict
    cp_params: dict
    state: BatchGenState
    trailing: torch.Tensor  # [B, Tb, hidden]
    trailing_lens: list[int]
    pad_embed: torch.Tensor  # [hidden]
    uniforms: torch.Tensor  # [B, max_new + 1]
    frame_limits: list[int]  # per-stream frame budgets


class BatchRun:
    """A replica's loop for one driver call: its share, the configs, and its
    limits and text schedule on its first device (sent once a call)."""

    def __init__(self, share: ReplicaLoop, tcfg: TalkerConfig, cpcfg: CodePredictorConfig,
                 scfg: sampling.SamplingConfig, mesh):
        _check_mesh(share.talker_params, mesh)
        self.share, self.state, self.tcfg, self.cpcfg, self.scfg = share, share.state, tcfg, cpcfg, scfg
        self.dev = share.state.frames.device
        self.max_new = share.state.frames.shape[1]
        limits = [min(limit, self.max_new) for limit in share.frame_limits]  # never run past the frames buffer
        self.top = max(limits, default=0)
        with collectives.device_scope(self.dev):
            self.limits = to_device(limits, self.dev)
            self.in_text_until = to_device(list(share.trailing_lens), self.dev)
            self.suppression = sampling.build_suppression_mask(share.state.penalty_mask.shape[1], scfg.eos_token_id,
                                                               self.dev)

    def idle(self) -> torch.Tensor:
        """[] bool on the replica's device: no stream is live."""
        with collectives.device_scope(self.dev):
            return _idle(self.state, self.limits)


def batch_frame(run: BatchRun) -> None:
    """Launch one frame of one replica's streams on its devices (no read):
    every projection multiplies its B rows with one weight read; a stream
    that is done or at its limit is frozen by a device-side select."""
    state, share, scfg = run.state, run.share, run.scfg
    tp, cpp = share.talker_params, share.cp_params
    with collectives.device_scope(run.dev):
        idx = state.steps
        live = ~state.done & (state.frame_idx < run.limits)
        semantic_embed = talker.embed_codec(tp, state.token)[:, None, :]  # [B, 1, H]
        codes = cp.predict_acoustic_codes_batch(cpp, run.cpcfg, state.last_hidden, semantic_embed)  # [B, 15]
        frame = torch.cat([state.token[:, None].to(torch.int32), codes], dim=1)
        state.frames[:, idx] = torch.where(live[:, None], frame, state.frames[:, idx])

        acoustic_sum = cp.acoustic_embedding_sum(cpp, codes).to(semantic_embed.dtype)
        trailing = share.trailing
        text_add = torch.where((run.in_text_until > idx)[:, None], trailing[:, min(idx, trailing.shape[1] - 1)],
                               share.pad_embed)
        step_input = semantic_embed + acoustic_sum + text_add.to(semantic_embed.dtype)[:, None, :]
        hidden, logits = talker.decode_step_batch(tp, run.tcfg, step_input, state.pos, state.cache)

        token_count = idx + 1
        logits = sampling.apply_generation_penalties(logits, state.penalty_mask, run.suppression, scfg, token_count)
        next_token = sampling.sample_rows(logits, scfg, share.uniforms[:, min(token_count, run.max_new)])
        seen = state.penalty_mask.gather(1, next_token[:, None])
        state.penalty_mask.scatter_(1, next_token[:, None], torch.where(live[:, None], torch.ones_like(seen), seen))

        state.last_hidden = torch.where(live[:, None, None], hidden, state.last_hidden)
        state.token = torch.where(live, next_token, state.token)
        state.done = state.done | (live & (next_token == scfg.eos_token_id))
        state.frame_idx = state.frame_idx + live
        state.pos = state.pos + 1
        state.steps = token_count


def _look(reader, runs: list[BatchRun], on: list[bool]) -> list[bool]:
    """One look at every replica still in: which stay in (not idle). A lone
    replica's look reads its flag alone, as the batch-1 loop's does."""
    flags = [run.idle() if o else None for run, o in zip(runs, on)]
    idle = [reader.read(flags[0])] if len(runs) == 1 else reader.read(flags)
    return [o and not i for o, i in zip(on, idle)]


def generate_frames_replicas(
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    shares: list[ReplicaLoop],
    mesh=None,  # parallel.sharding.Mesh of a sharded model (each share's talker its replica's ShardedTree)
    until=None,  # () -> bool: stop launching once True, with no look at the device (generate_frames')
) -> list[BatchGenState]:
    """Advance the dp replicas of one batch in lock-step, as the JAX
    package's one vmapped program over dp advances every replica the same
    frame in the same step; returns their states, in order.

    The host runs rounds: a round launches the next frame (``batch_frame``)
    of every replica still in, in replica order, each on its own devices,
    so replicas on distinct cards run at once. A replica is in while its
    ``steps`` is below its largest limit and no look has shown it idle. The
    group looks once on entry and every ``DONE_READ_EVERY`` rounds: each
    replica's idle flag goes into its element of one pinned slot, and the
    host reads the previous look's slot once (``_FlagReader``); so each
    replica runs at most ``2 * DONE_READ_EVERY - 1`` frozen frames past
    its EOS, as alone. ``until``, when given, is called once a round, before
    any replica launches, and ends the rounds with no look: a cut leaves
    every replica that was in at the same ``steps``."""
    tcfg = replace(tcfg, decode_tiering=False)
    runs = [BatchRun(share, tcfg, cpcfg, scfg, mesh) for share in shares]
    on = [run.state.steps < run.top for run in runs]
    reader = None
    if until is None and any(on):
        devs = [run.dev for run in runs]
        reader = _FlagReader(devs[0] if len(runs) == 1 else devs)
        on = _look(reader, runs, on)
    rounds = 0
    while any(on):
        if until is not None and until():
            break
        for run, o in zip(runs, on):
            if o:
                batch_frame(run)
        rounds += 1
        on = [o and run.state.steps < run.top for run, o in zip(runs, on)]
        if reader is not None and rounds % DONE_READ_EVERY == 0 and any(on):
            on = _look(reader, runs, on)
    return [run.state for run in runs]


def generate_frames_batch(
    talker_params: dict,
    cp_params: dict,
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    state: BatchGenState,
    trailing: torch.Tensor,  # [B, Tb, hidden]
    trailing_lens: list[int],
    pad_embed: torch.Tensor,  # [hidden]
    uniforms: torch.Tensor,  # [B, max_new + 1]
    frame_limits: list[int],  # per-stream frame budgets
    mesh=None,  # parallel.sharding.Mesh of a sharded model (talker_params one replica's ShardedTree)
    until=None,  # () -> bool: stop launching once True, with no look at the device (generate_frames')
) -> BatchGenState:
    """Advance B streams together until each is done or at its frame limit
    (the semantics of the JAX package's vmapped ``_generate_frames``): the
    one-replica case of ``generate_frames_replicas``.

    The body runs for all B streams at once, on the layer path
    (``talker.decode_step_batch``, ``cp.predict_acoustic_codes_batch``):
    every projection multiplies the B rows with one weight read. A stream
    that is done or at its limit keeps its token, penalty mask, frames,
    frame count and last hidden state (a device-side select on ``live``);
    its cache position goes on advancing (the rows it writes lie past its
    live frontier and are never read). The limits go to the device once a
    call. Every live stream has made ``state.steps`` frames (all start
    together, and a stream stops being live only for good within a call:
    the limits a session raises are all its common target), so the frame
    row, the text row, the uniform's index and the min-new-tokens count
    are host integers. The host stops at the largest limit, or when a look
    at the device (on entry and every ``DONE_READ_EVERY`` iterations,
    lagged on the card) shows no stream live; with ``until``, when it
    returns True, with no look (``generate_frames``' ``until``, a
    ``StreamingBatchSession``'s chunk queued ahead). Tiered decode attention is off here, as in
    the JAX package's batched programs (its window is picked per stream
    position, on the host at batch 1). Under a ``mesh`` the talker is one
    replica's ``ShardedTree`` (the tensor-parallel layer path) holding this
    state's streams, the code predictor that replica's, on its first
    device.
    """
    share = ReplicaLoop(talker_params, cp_params, state, trailing, trailing_lens, pad_embed, uniforms, frame_limits)
    return generate_frames_replicas(tcfg, cpcfg, scfg, [share], mesh, until)[0]


def _idle(state: BatchGenState, limits: torch.Tensor) -> torch.Tensor:
    """[] bool: no stream is live (each done or at its limit)."""
    return ~(~state.done & (state.frame_idx < limits)).any()
