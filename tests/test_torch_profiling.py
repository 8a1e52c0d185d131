"""``profiling.TransferAudit`` / ``count_host_transfers`` of the port (CPU).

Mirrors ``tests/test_profiling.py``: every route by which a tensor's value
reaches the host is counted, once (``.item()``, ``.tolist()``, ``bool`` /
``int`` / ``float`` / ``__index__``, ``np.asarray`` / ``.numpy()``; and
``.cpu()`` and ``.to`` onto the CPU of a tensor that is not on the CPU,
here a ``meta`` tensor, which the hook counts before the copy refuses it);
``torch.Tensor`` is restored on exit, and nothing is counted outside the
context. Reads planted in a loop are counted exactly. Then a regression
guard on the port's frame loops (the tiny Base model of
``test_torch_voice_clone.py``): ``generate_frames`` (batch 1) and
``generate_frames_batch`` (B = 3) look at the device once every
``core.DONE_READ_EVERY`` frames, at most ceil(frames / N) + 2 reads a call;
a PR that adds a read to either loop fails here.
"""

import math

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import profiling
from qwen3_tts_tpu_torch.generation import core
from qwen3_tts_tpu_torch.pipeline import SynthesisOptions
from qwen3_tts_tpu_torch.profiling import TransferAudit, count_host_transfers
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

ROUTES = {
    "item": lambda t: t.item(),
    "tolist": lambda t: t.tolist(),
    "bool": bool,
    "int": int,
    "float": float,
    "index": lambda t: [10, 11, 12, 13][t],
    "asarray": np.asarray,
    "numpy": lambda t: t.numpy(),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_value_reads_counted_once(route):
    t = torch.tensor(2)
    with TransferAudit() as audit:
        ROUTES[route](t)
    assert audit.transfers == 1


@pytest.mark.parametrize("copy", ["cpu", "to_str", "to_device", "to_tensor", "to_kwarg"])
def test_copies_to_the_host_counted_once(copy):
    """A tensor off the CPU copied to it counts once (the meta tensor stands
    in for a card's: its copy raises after the hook has counted)."""
    off = torch.empty(3, device="meta")
    calls = {"cpu": lambda: off.cpu(), "to_str": lambda: off.to("cpu"), "to_device": lambda: off.to(torch.device("cpu")),
             "to_tensor": lambda: off.to(torch.zeros(1)), "to_kwarg": lambda: off.to(device="cpu", dtype=torch.float16)}
    with TransferAudit() as audit:
        with pytest.raises(NotImplementedError):
            calls[copy]()
    assert audit.transfers == 1


def test_moves_that_do_not_reach_the_host_are_not_counted():
    host = torch.arange(4.0)
    off = torch.empty(3, device="meta")
    with TransferAudit() as audit:
        host.cpu()  # already there: nothing moves
        host.to("cpu")
        host.to(torch.float64)
        off.to(torch.float16)  # stays on its device
        off.to(device="meta")
        host.sum() * 2
    assert audit.transfers == 0


def test_audit_restores_hooks():
    before = {name: torch.Tensor.__dict__.get(name) for name in profiling._VALUE_READS + profiling._COPIES}
    with TransferAudit():
        assert all(torch.Tensor.__dict__.get(name) is not before[name] for name in before)
    assert {name: torch.Tensor.__dict__.get(name) for name in before} == before
    audit = TransferAudit()
    int(torch.tensor(3))  # outside any audit: not counted, not raised
    assert audit.transfers == 0


def test_audit_restores_hooks_on_error():
    before = torch.Tensor.__dict__.get("item")
    with pytest.raises(RuntimeError):
        with TransferAudit():
            raise RuntimeError("boom")
    assert torch.Tensor.__dict__.get("item") is before


def test_planted_reads_in_a_loop_counted_exactly():
    x = torch.arange(12.0)

    def loop(n: int) -> float:
        acc = torch.zeros(())
        total = 0.0
        for i in range(n):
            acc = acc + x[i]
            if bool(acc > 100):  # one read a step
                break
            if i % 3 == 0:
                total += acc.item()  # one read every third step
        return total + float(acc)  # one read at the end

    for n in (1, 6, 10):
        total, reads = count_host_transfers(loop, n)
        assert reads == n + len(range(0, n, 3)) + 1, (n, reads)
        assert total == loop(n)


@pytest.fixture(scope="module")
def model():
    return build_models()[1]


def _read_bound(frames: int) -> int:
    """The loop contract: one look at the device every
    ``core.DONE_READ_EVERY`` iterations, plus a constant."""
    return math.ceil(frames / core.DONE_READ_EVERY) + 2


@pytest.mark.parametrize("frames", [4, 12, 40])
def test_batch1_loop_reads_once_every_n_frames(model, frames):
    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=3)
    session = model._custom_voice_session("Hello there", "ryan", "english", opts)
    _, reads = count_host_transfers(session._advance, frames)
    assert session.state.steps == int(session.state.frame_idx) == frames
    assert reads <= _read_bound(frames), reads


@pytest.mark.parametrize("frames", [4, 12, 40])
def test_batched_loop_reads_once_every_n_frames(model, frames):
    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=3)
    m = model
    g = m._prepare_batch_group("basic", ["a b", "c d e", "f"], ["ryan"] * 3, ["english"] * 3, [None] * 3, opts,
                               [1, 2, 3])
    _, reads = count_host_transfers(core.generate_frames_batch, m.talker_params, m.cp_params, m.config.talker,
                                    m.config.code_predictor, g.scfg, g.state, g.trailing, g.trailing_lens,
                                    g.pad_embed, g.uniforms, g.frame_limits)
    assert g.state.frame_idx.tolist() == [frames] * 3 and g.state.steps == frames
    assert reads <= _read_bound(frames), reads
