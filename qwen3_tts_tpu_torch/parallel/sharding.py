"""Multi-GPU serving: the (dp, tp) device mesh, partition specs, placement.

The port of ``qwen3_tts_tpu/parallel/sharding.py``. The parallelism is the
JAX package's:

* **tp** (tensor parallel): attention heads, MLP intermediate and the codec
  head's vocabulary split over the ranks of a replica, Megatron style:
  column-parallel q / k / v and gate / up, row-parallel o and down, one
  all-reduce after each before the residual add (``parallel/collectives``).
* **dp** (data parallel): a batch's streams split over replicas, each a full
  tp group.

Where GSPMD partitions a global program from these specs, the port runs each
rank's slice itself: ``shard_pytree`` gives every rank a tree of its own on
its device, and the layer paths (``ops/nn.run_layer_stack_tp``,
``ops/fused_layer.tp_decode_step``) reduce between the ranks. So a rank's
slice must be whole heads: a fused ``[q|k|v]`` or ``[gate|up]`` splits block
by block (a rank holds its share of each block, concatenated; ``P.blocks``),
never as contiguous chunks of the concatenation, and tp must divide the
heads, KV heads and widths it splits.

A spec is a ``P``: one entry a leaf axis, None (whole on every rank), "tp"
or "dp", as JAX's ``PartitionSpec``. The code predictor is not split: each
replica holds it whole on its first device (``Qwen3TTS.shard``), so
``code_predictor_specs`` has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import TalkerConfig
from ..ops import quant
from . import collectives


class P(tuple):
    """A leaf's partition spec (JAX's ``PartitionSpec``: compares equal to the
    tuple of its axes). ``blocks``: the widths of the blocks concatenated
    along the "tp" axis (a fused projection), each split on its own."""

    def __new__(cls, *axes, blocks: tuple = ()):
        spec = super().__new__(cls, axes)
        spec.blocks = tuple(blocks)
        return spec

    def __repr__(self) -> str:
        extra = f", blocks={self.blocks}" if self.blocks else ""
        return f"P({', '.join(map(repr, self))}{extra})"


class Mesh:
    """A (dp, tp) grid of ``torch.device``s: replica r's tp ranks are
    ``devices[r]``. A device may appear more than once (ranks that share
    it, as on the CPU or one card); the ranks of a replica are all one
    device or all distinct cards, and the CPU and cards do not mix."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = _device(d)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) grid of devices; got shape {grid.shape}")
        if len({d.type for d in grid.flat}) > 1:
            raise ValueError(f"a mesh mixes device types: {sorted({str(d) for d in grid.flat})}")
        for row in grid:
            collectives.route(list(row))  # raises on a mixed tp group
        self.devices = grid
        self.shape = {"dp": grid.shape[0], "tp": grid.shape[1]}

    def replica(self, r: int) -> list[torch.device]:
        """Replica r's tp ranks' devices, in rank order."""
        return list(self.devices[r])

    def replica_mesh(self, r: int) -> "Mesh":
        """Replica r alone, as a (1, tp) mesh."""
        return Mesh(self.devices[r:r + 1])

    def first(self, r: int) -> torch.device:
        """Replica r's first device: its code predictor, vocoder, sampling."""
        return self.devices[r, 0]

    def __repr__(self) -> str:
        rows = [[str(d) for d in row] for row in self.devices]
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, devices={rows})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {d}")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {d.index}: {torch.cuda.device_count()} present")
    elif d.type != "cpu":
        raise ValueError(f"a mesh holds CUDA cards or the CPU, not {d}")
    return d


def make_mesh(devices=None, tp: int | None = None, dp: int | None = None) -> Mesh:
    """Build a (dp, tp) mesh. Defaults: tp the largest of 8, 4, 2, 1 that
    divides the device count n, dp = n // tp. ``devices`` None takes every
    visible CUDA card and raises when there is none (no CPU fallback); a
    list may repeat a device (ranks sharing it, e.g. ``["cpu"] * 4``)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] (e.g. ['cpu'] * 4) to build a mesh "
                               "of CPU ranks")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if tp is None:
        tp = next(c for c in (8, 4, 2, 1) if n % c == 0)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


def _with_scale(spec: P) -> dict:
    """Spec pair for a quantized linear ``{"q8", "scale"}``: q8 keeps the
    plain weight's spec; the per-output-channel scale carries every axis
    but the contraction (second-to-last) one, so a column-parallel weight's
    scale splits with its columns and a row-parallel one's is whole on
    every rank (the reduction is of the activations)."""
    axes = tuple(spec)
    return {"q8": spec, "scale": P(*axes[:-2], axes[-1], blocks=spec.blocks)}


def _adapt(spec: P, leaf) -> P | dict:
    """A logical weight spec matched to the leaf (plain or quantized)."""
    return _with_scale(spec) if quant.is_quantized(leaf) else spec


def _dims(w) -> tuple[int, int]:
    """(K, N) of a stacked linear, plain or quantized."""
    t = w["q8"] if quant.is_quantized(w) else w
    return t.shape[-2], t.shape[-1]


def layer_stack_specs(layers: dict | None = None) -> dict:
    """Specs of a stacked decoder-layer tree [L, ...]: q / k / v and gate /
    up column-parallel, o and down row-parallel, norms whole.

    Pass the ``layers`` subtree to match a fused (``qkv_proj`` /
    ``gateup_proj``) or int8 (``{"q8", "scale"}``) tree. A fused leaf's spec
    carries its blocks, read from the tree: q / k / v widths (o's K, then
    the rest halved) and gate / up (down's K, twice).
    """
    base = {
        "q_proj": P(None, None, "tp"),
        "k_proj": P(None, None, "tp"),
        "v_proj": P(None, None, "tp"),
        "o_proj": P(None, "tp", None),
        "q_norm": P(None, None),
        "k_norm": P(None, None),
        "input_ln": P(None, None),
        "post_ln": P(None, None),
        "gate_proj": P(None, None, "tp"),
        "up_proj": P(None, None, "tp"),
        "down_proj": P(None, "tp", None),
    }
    if layers is None:
        return base
    if "qkv_proj" in layers:
        qd = _dims(layers["o_proj"])[0]
        kvd = (_dims(layers["qkv_proj"])[1] - qd) // 2
        inter = _dims(layers["down_proj"])[0]
        base["qkv_proj"] = P(None, None, "tp", blocks=(qd, kvd, kvd))
        base["gateup_proj"] = P(None, None, "tp", blocks=(inter, inter))
        for key in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            del base[key]
    missing = set(base) - set(layers)
    if missing:
        raise ValueError(f"layer stack missing expected weights {sorted(missing)}; pass the actual params['layers'] "
                         "subtree so specs match its structure (fused/int8 trees included)")
    return {key: _adapt(spec, layers[key]) for key, spec in base.items()}


def talker_specs(cfg: TalkerConfig, params: dict | None = None) -> dict:
    """The talker's serving specs: the text projection's fc1 column-split and
    fc2 row-split, the codec head split by vocabulary, embeddings and the
    final norm whole; pass ``params`` to mirror fused / int8 trees (and its
    ``tp_pack``)."""
    layers = params["layers"] if params is not None else None
    head = params["codec_head"] if params is not None else None
    specs = {
        "text_embedding": P(None, None),
        "text_projection": {"fc1_w": P(None, "tp"), "fc1_b": P("tp"), "fc2_w": P("tp", None), "fc2_b": P(None)},
        "codec_embedding": P(None, None),
        "layers": layer_stack_specs(layers),
        "norm": P(None),
        "codec_head": _adapt(P(None, "tp"), head),
    }
    if params is not None and "tp_pack" in params:
        specs["tp_pack"] = tp_pack_specs()
    return specs


def tp_pack_specs() -> dict:
    """Specs of the head-aligned qkv / gate|up re-layout
    (``ops/fused_layer.make_tp_pack``): its columns are permuted so that
    contiguous chunk i is rank i's (q_i|k_i|v_i) / (gate_i|up_i); q8 and
    the per-output-channel scale split by plain chunks."""
    col = {"q8": P(None, None, "tp"), "scale": P(None, "tp")}
    return {"qkv": dict(col), "gu": dict(col)}


def kv_cache_spec() -> P:
    """A talker KV cache [L, B, S, KV, D]: streams on dp, KV heads on tp (the
    JAX package's spec, in the layout both packages give such a cache; the
    same spec as ``batch_cache_spec``)."""
    return P(None, "dp", None, "tp", None)


def serving_cache_spec() -> P:
    """The batch-1 serving cache [L, B=1, S, KV, D]: KV heads on tp (batch 1
    does not split over dp: it runs on replica 0)."""
    return P(None, None, None, "tp", None)


def batch_cache_spec() -> P:
    """The batched cache, in the port's layout [L, B, S, KV, D] (the JAX
    package's is [B, L, 1, S, KV, D]): streams on dp, KV heads on tp."""
    return P(None, "dp", None, "tp", None)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _piece(t: torch.Tensor, axis: int, n: int, i: int, blocks: tuple = ()) -> torch.Tensor:
    """Piece i of n of ``t`` along ``axis``: a contiguous chunk, or with
    ``blocks`` (widths summing to the axis) piece i of each block,
    concatenated."""
    width = t.shape[axis]
    blocks = blocks or (width,)
    if sum(blocks) != width or any(b % n for b in blocks):
        raise ValueError(f"cannot split an axis of {width} ({blocks}) into {n} equal pieces per block")
    parts, at = [], 0
    for b in blocks:
        parts.append(t.narrow(axis, at + i * (b // n), b // n))
        at += b
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def shard_leaf(leaf: torch.Tensor, spec: P, mesh: Mesh) -> list[list[torch.Tensor]]:
    """Rank (r, t)'s piece of ``leaf`` on its device, as ``out[r][t]``. A
    whole leaf is moved (no copy on a device that already holds it); a split
    one is copied once a (piece, device), so ranks that share a device and a
    piece share the tensor."""
    if len(spec) != leaf.dim():
        raise ValueError(f"spec {spec!r} for a leaf of shape {tuple(leaf.shape)}")
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    made: dict = {}
    out = []
    for r in range(dp):
        row = []
        for t in range(tp):
            key = (r if "dp" in spec else None, t if "tp" in spec else None, mesh.devices[r, t])
            if key not in made:
                piece = leaf
                if "dp" in spec:
                    piece = _piece(piece, spec.index("dp"), dp, r)
                if "tp" in spec:
                    piece = _piece(piece, spec.index("tp"), tp, t, spec.blocks)
                # A view of the leaf is copied (so the leaf can be freed); a whole leaf is only moved.
                made[key] = piece.to(key[2], copy=piece._base is not None, memory_format=torch.contiguous_format)
            row.append(made[key])
        out.append(row)
    return out


def _map(tree, specs, fn, path: str = ""):
    """``fn(leaf, spec)`` over matching trees (None leaves stay None); a
    structure mismatch raises, as ``jax.tree.map`` does."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"specs do not mirror the tree at '{path}': {sorted(tree)} against "
                             f"{sorted(specs) if isinstance(specs, dict) else specs!r}")
        return {k: _map(tree[k], specs[k], fn, f"{path}/{k}") for k in tree}
    if tree is None:
        return None
    return fn(tree, specs)


def _unzip(tree, r: int, t: int):
    if isinstance(tree, dict):
        return {k: _unzip(v, r, t) for k, v in tree.items()}
    return None if tree is None else tree[r][t]


def shard_pytree(params: dict, specs: dict, mesh: Mesh) -> list[list[dict]]:
    """Every rank's tree, ``out[r][t]`` on ``mesh.devices[r, t]``, each leaf
    split by its spec (``shard_leaf``)."""
    pieces = _map(params, specs, lambda leaf, spec: shard_leaf(leaf, spec, mesh))
    return [[_unzip(pieces, r, t) for t in range(mesh.shape["tp"])] for r in range(mesh.shape["dp"])]


def place_pytree(params: dict, device: torch.device) -> dict:
    """``params`` (dicts, lists and tuples of tensors) whole on ``device``
    (no copy of a leaf already there)."""
    if isinstance(params, dict):
        return {k: place_pytree(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_pytree(v, device) for v in params)
    return params.to(device) if isinstance(params, torch.Tensor) else params


def replicate_pytree(params: dict, mesh: Mesh) -> list[list[dict]]:
    """``params`` whole on every rank's device, ``out[r][t]`` (one copy a
    device)."""
    placed: dict = {}
    return [[placed.setdefault(d, place_pytree(params, d)) for d in mesh.replica(r)] for r in range(mesh.shape["dp"])]


class ShardedTree:
    """One replica's tensor-parallel tree: ``ranks[t]`` is tp rank t's tree
    (``shard_pytree``'s row) on ``devices[t]``. Indexing reads rank 0's
    tree: a whole leaf (an embedding, a norm) on the replica's first device.
    The model code that splits work over the ranks
    (``models/talker``, ``ops/nn.run_layer_stack_tp``) reads ``ranks``."""

    def __init__(self, ranks: list[dict], devices: list[torch.device]):
        if len(ranks) != len(devices):
            raise ValueError(f"{len(ranks)} rank trees for {len(devices)} devices")
        self.ranks = ranks
        self.devices = [torch.device(d) for d in devices]

    @property
    def tp(self) -> int:
        return len(self.ranks)

    def __getitem__(self, key: str):
        return self.ranks[0][key]

    def __contains__(self, key: str) -> bool:
        return key in self.ranks[0]

    def get(self, key: str, default=None):
        return self.ranks[0].get(key, default)

    def keys(self):
        return self.ranks[0].keys()
