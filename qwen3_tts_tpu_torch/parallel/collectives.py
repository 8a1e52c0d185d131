"""Collectives over the tensor-parallel ranks of one replica.

The port's counterparts of ``jax.lax.psum(..., "tp")`` and of the gathers
and broadcasts that GSPMD inserts around a sharded program. A rank's tensor
is one entry of a list, in rank order, each on its rank's device. The route
follows from the devices alone:

* ``"nccl"``: the ranks sit on distinct CUDA cards. One process drives them
  all through ``torch.cuda.nccl`` (one tensor per card, on each card's
  current stream). PyTorch makes the communicators of a set of cards on its
  first collective there and keeps them; ``connect`` makes that call, so
  ``Qwen3TTS.shard`` pays for it and not the first frame. A failure raises.
* ``"local"``: the ranks share one device (the CPU tests, a machine with one
  card). A sum in rank order in the parts' dtype, as the JAX psum adds bf16
  parts in bf16.

Ranks that are neither all distinct cards nor all on one device raise
(``parallel.sharding.Mesh`` refuses such a mesh). ``counts[(op, route)]``
counts every call by the route it took.
"""

from __future__ import annotations

import collections
import contextlib

import torch

# ncclRedOp_t: ncclSum, ncclMax.
_NCCL_OPS = {"sum": 0, "max": 2}

counts: collections.Counter = collections.Counter()


def route(devices) -> str:
    """``"local"`` when every device is the same one, ``"nccl"`` when they
    are distinct CUDA cards; anything else raises."""
    devices = [torch.device(d) for d in devices]
    if all(d == devices[0] for d in devices[1:]):
        return "local"
    if len(set(devices)) == len(devices) and all(d.type == "cuda" and d.index is not None for d in devices):
        return "nccl"
    raise ValueError(f"tensor-parallel ranks on {[str(d) for d in devices]}: neither all one device nor all "
                     "distinct CUDA cards")


def _route(parts: list) -> str:
    d0 = parts[0].device
    if all(p.device == d0 for p in parts[1:]):
        return "local"
    return route([p.device for p in parts])


def device_scope(dev: torch.device):
    """The device a rank's kernels launch on: ``torch.cuda.device(dev)`` for a
    card (the kernels' C entries launch on the current device), nothing for
    the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def all_reduce(parts: list, op: str = "sum") -> list:
    """Every rank's ``op`` ("sum" or "max") of ``parts``, one tensor a rank
    on its device (on the NCCL route the parts are reduced in place; on the
    local route every rank gets the same tensor)."""
    r = _route(parts)
    counts["all_reduce", r] += 1
    if r == "nccl":
        torch.cuda.nccl.all_reduce(parts, op=_NCCL_OPS[op])
        return parts
    total = parts[0]
    for p in parts[1:]:
        total = total + p if op == "sum" else torch.maximum(total, p)
    return [total] * len(parts)


def broadcast(x: torch.Tensor, devices: list) -> list:
    """``x`` on each of ``devices`` (``x`` lies on the first)."""
    r = route(devices)
    counts["broadcast", r] += 1
    if r == "local":
        return [x] * len(devices)
    x = x.contiguous()
    out = [x] + [torch.empty_like(x, device=d) for d in devices[1:]]
    torch.cuda.nccl.broadcast(out, root=0)
    return out


def gather(parts: list, to: torch.device, dim: int = -1) -> torch.Tensor:
    """The ranks' ``parts`` concatenated along ``dim`` on ``to`` (a rank's
    device): the column-parallel outputs put back together."""
    r = _route(parts)
    counts["gather", r] += 1
    if r == "local":
        return torch.cat(parts, dim=dim).to(to)
    parts = [p.contiguous() for p in parts]
    n = len(parts)
    outs = [p.new_empty((n, *p.shape)) for p in parts]
    torch.cuda.nccl.all_gather(parts, outs)
    whole = outs[[p.device for p in parts].index(torch.device(to))]  # [n, ..., w]
    dim = dim % parts[0].dim()
    return torch.cat(whole.unbind(0), dim=dim)


def connect(devices: list) -> None:
    """Make the NCCL communicators of ``devices`` now (one all-reduce of one
    value a card, waited for); nothing on the local route."""
    if route(devices) != "nccl":
        return
    parts = [torch.ones(1, device=d) for d in devices]
    torch.cuda.nccl.all_reduce(parts)
    for d in devices:
        torch.cuda.synchronize(d)
    if any(float(p) != len(devices) for p in parts):
        raise RuntimeError(f"NCCL all-reduce over {[str(d) for d in devices]} gave {[float(p) for p in parts]}")
