"""The fused code-predictor and talker kernels: CUDA kernel wrappers, plain
versions, launch counts, and the JAX package's gates between them.

``cp_frame`` computes all acoustic codes of one frame. On a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/cp_frame.cu``, the port of
``qwen3_tts_tpu/ops/fused_layer.py:streamed_cp_frame``); on a CPU tensor it
runs ``cp_frame_plain``, the plain PyTorch version (the JAX package's
``predict_acoustic_codes``: a 2-row prefill, then 14 single-token steps,
each with the mtp projection and a greedy argmax). It takes plain (f32 or
bf16) and weight-only int8 code-predictor trees.

``talker_step`` runs one batch-1 decode step through every talker layer on
int8 or plain (f32 / bf16) weights (``csrc/talker_step.cu``, the port of
both forms of ``streamed_talker_step``), one persistent launch a step
through the tree's ``TalkerStepPack`` (plan: ``talker_step_plan``); its
plain version is ``talker_step_plain``.

The per-step int8 code predictor, for trees the frame kernel does not take
(``supports_cp_frame_kernel``): ``fused_attention_step`` and
``fused_mlp_step`` (``csrc/fused_step.cu``, the ports of the JAX package's
functions of those names, one persistent launch a call through the layer
stack's ``FusedStepPack``, plan ``fused_step_plan``; ``residual=False``
gives the tensor-parallel partials) and ``streamed_decode_step`` (the port
of ``streamed_decode_step``,
reading the canonical int8 tree instead of the stream pack: kernel 3's
body in its normalised form, ``csrc/talker_step.cu``, one persistent
launch a step through the tree's ``CpStepPack``), chosen per step by
``run_fused_decode_step``.

``tp_decode_step`` is the tensor-parallel talker step (kernels 5 and 6 on
every rank with ``residual=False``, an all-reduce between them) on the
head-aligned re-layout of ``make_tp_pack``, each rank through its own
``FusedStepPack`` (``tp_step_packs``).

Every wrapper runs its plain version on CPU tensors, launches its kernel on
CUDA tensors (or raises), and raises on any other device.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives
from . import nn, quant

# 2 prefill positions + 15 decode tokens; the last is never attended, as in
# the JAX package.
CP_MAX_SEQ = 17
# The JAX package's bound for the streamed talker step (fused_layer.py);
# every generation tier (2048 frames + prompt bucket + pad) fits.
TALKER_STREAM_MAX_SEQ = 2624

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PROJS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def mtp_project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The small-to-mtp projection (embed_dim -> hidden), when the model has one."""
    proj = params.get("mtp_proj")
    if proj is None:
        return x
    return x @ proj["w"] + proj["b"]


def head(heads, g: int):
    """Head ``g`` of the stacked lm heads, plain [G, H, V] or quantized."""
    if quant.is_quantized(heads):
        return {"q8": heads["q8"][g], "scale": heads["scale"][g]}
    return heads[g]


def cp_frame_layers(
    params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor, matmul
) -> torch.Tensor:
    """All ``cfg.num_acoustic`` codes of one frame through the layer stack
    (the JAX package's plain ``predict_acoustic_codes`` path), every
    projection and head through ``matmul``.

    talker_hidden, semantic_embed: [1, 1, embed_dim]. Returns int32 [G].
    Group g embeds code g-1 with table g-1 and predicts with head g.
    """
    return cp_frame_layers_batch(params, cfg, talker_hidden, semantic_embed, matmul)[0]


def cp_frame_layers_batch(
    params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor, matmul
) -> torch.Tensor:
    """``cp_frame_layers`` for B frames at once (talker_hidden,
    semantic_embed: [B, 1, embed_dim]; a cache of B streams, every
    projection of the B rows in one ``matmul``). The positions are the same
    for every stream: 2 prefill rows, then 14 steps. Returns int32 [B, G]."""
    stack_cfg = cfg.layer_stack()
    dev = talker_hidden.device
    cache = nn.init_kv_cache(stack_cfg, talker_hidden.shape[0], CP_MAX_SEQ, talker_hidden.dtype, dev)
    heads = params["lm_heads"]

    x = mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    h = nn.run_layer_stack(
        params["layers"], x, stack_cfg, cache, torch.arange(2, device=dev), 0, self_attn_prefill=True, matmul=matmul
    )
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    code = torch.argmax(matmul(h[:, 1], head(heads, 0)), dim=-1)  # [B]
    codes = [code]
    for g in range(1, cfg.num_acoustic):
        pos = g + 1
        x = mtp_project(params, params["codec_embeddings"][g - 1][code][:, None])
        h = nn.run_layer_stack(
            params["layers"], x, stack_cfg, cache, torch.full((1,), pos, device=dev), pos, matmul=matmul
        )
        h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
        code = torch.argmax(matmul(h[:, 0], head(heads, g)), dim=-1)
        codes.append(code)
    return torch.stack(codes, dim=1).to(torch.int32)


def cp_frame_plain(params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor) -> torch.Tensor:
    """Kernel 1's plain version: ``cp_frame_layers`` with int8 layers and
    heads through ``quant.mm_plain`` on every device."""
    return cp_frame_layers(params, cfg, talker_hidden, semantic_embed, quant.mm_plain)


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device: torch.device, op="cp_frame") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{op}: {name} must be a contiguous {dtype} tensor of shape {shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _check_linear(w, name: str, shape: tuple, dtype, device, op: str) -> bool:
    """Check a plain (``dtype``) or int8 linear; returns whether it is int8."""
    if quant.is_quantized(w):
        _check(w["q8"], f"{name}.q8", shape, torch.int8, device, op)
        _check(w["scale"], f"{name}.scale", shape[:-2] + shape[-1:], torch.float32, device, op)
        return True
    _check(w, name, shape, dtype, device, op)
    return False


def _check_linears(linears: dict, dtype, device, op: str) -> bool:
    """Check every linear of ``linears`` (name -> (weight, shape)); returns
    whether they are int8, and raises unless all are int8 or all plain."""
    int8 = {name: _check_linear(w, name, shape, dtype, device, op) for name, (w, shape) in linears.items()}
    if len(set(int8.values())) != 1:
        raise ValueError(f"{op}: the projections must be all int8 or all plain ({int8})")
    return next(iter(int8.values()))


_ROPE_TABLES: dict = {}


def rope_tables(head_dim: int, theta: float, rows: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [rows, head_dim/2] f32 for positions 0..rows-1, made once per device."""
    key = (head_dim, theta, rows, dev)
    if key not in _ROPE_TABLES:
        inv_freq = nn.rope_inv_freq(head_dim, theta, device=dev)
        cos_t, sin_t = nn.rope_cos_sin(torch.arange(rows, dtype=torch.float32, device=dev), inv_freq)
        _ROPE_TABLES[key] = (cos_t.contiguous(), sin_t.contiguous())
    return _ROPE_TABLES[key]


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_fused_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_cp_frame_scratch_floats.restype = ctypes.c_size_t
        lib.q3_cp_frame_scratch_floats.argtypes = [ctypes.POINTER(i32)]
        lib.q3_cp_frame.restype = i32
        lib.q3_cp_frame.argtypes = [
            i32, i32, ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ptr), ptr, ptr, ptr, ptr, ptr,
            ptr,
        ]
        lib.q3_cp_frame_maps_bytes.restype = ctypes.c_size_t
        lib.q3_cp_frame_maps_bytes.argtypes = []
        lib.q3_cp_frame_maps.restype = i32
        lib.q3_cp_frame_maps.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(ptr), ptr]
        lib.q3_cp_frame_trace_slots.restype = i32
        lib.q3_cp_frame_trace_slots.argtypes = [ctypes.POINTER(i32)]
        lib.q3_talker_step_scratch_floats.restype = ctypes.c_size_t
        lib.q3_talker_step_scratch_floats.argtypes = [ctypes.POINTER(i32)]
        lib.q3_talker_step_maps_bytes.restype = ctypes.c_size_t
        lib.q3_talker_step_maps_bytes.argtypes = []
        lib.q3_talker_step_maps.restype = i32
        lib.q3_talker_step_maps.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(ptr), ptr]
        lib.q3_talker_step_trace_slots.restype = i32
        lib.q3_talker_step_trace_slots.argtypes = [ctypes.POINTER(i32)]
        lib.q3_talker_step.restype = i32
        lib.q3_talker_step.argtypes = [
            i32, i32, ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ptr), ptr, ptr, ptr, ptr,
            ptr, i32, i32, ptr, ptr,
        ]
        lib.q3_fused_step_scratch_floats.restype = ctypes.c_size_t
        lib.q3_fused_step_scratch_floats.argtypes = [ctypes.POINTER(i32)]
        lib.q3_fused_step_maps_bytes.restype = ctypes.c_size_t
        lib.q3_fused_step_maps_bytes.argtypes = []
        lib.q3_fused_step_maps.restype = i32
        lib.q3_fused_step_maps.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(ptr), ptr]
        lib.q3_fused_step_trace_slots.restype = i32
        lib.q3_fused_step_trace_slots.argtypes = []
        lib.q3_fused_step_call_slots.restype = ctypes.c_size_t
        lib.q3_fused_step_call_slots.argtypes = []
        lib.q3_fused_step_call.restype = i32
        lib.q3_fused_step_call.argtypes = [ptr]
        lib.q3_cp_step.restype = i32
        lib.q3_cp_step.argtypes = [
            i32, ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ptr), ptr, ptr, ptr, ptr, ptr,
            ptr, ptr, i32, i32, ptr, ptr,
        ]
        lib._q3_fused_bound = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Kernel 1: the code-predictor frame, one persistent launch per frame
# ---------------------------------------------------------------------------

# The frame kernel's constants (csrc/cp_frame.cu): threads per block, ring
# stages, the shared memory an H100 block may take. The plan lays out the
# block's shared memory; the kernel takes the offsets and checks them.
CP_FRAME_THREADS = 256
CP_FRAME_STAGES = 4
CP_FRAME_SMEM_LIMIT = 232448
# Floats of attention and argmax scratch (the kernel uses 1888 of them).
CP_FRAME_MISC_FLOATS = 2048
# The most columns a TMA box row holds.
CP_FRAME_BOX_COLUMNS = 256
# The projections in the order a pass runs them (the kernel's enum Proj).
CP_FRAME_PROJS = ("mtp", "qkv", "o", "gate_up", "down", "head")
_WEIGHT_KINDS = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


class CpProjPlan(NamedTuple):
    """One projection of the frame kernel: ``k`` input rows, ``n`` output
    columns (the row stride) in ``halves`` halves (2 for gate|up: a block
    owns the same columns of both, so it finishes SiLU*up itself), cut into
    vectors of ``vec`` columns (16 bytes of weights). Block b owns vectors
    [b*nv, min((b+1)*nv, n/halves/vec)) of each half over the whole K;
    ``blocks`` blocks own any. A ring tile holds ``tile_rows`` K rows of a
    block's slice, loaded as TMA boxes of ``box_rows`` rows; a box row is
    the slice's ``nv`` vectors in one segment of ``box_vecs`` vectors (all
    ``nv``) or, for a slice wider than a box row's 256 columns, in segments
    of 256 columns (``box_vecs`` each)."""

    k: int
    n: int
    halves: int
    vec: int
    nv: int
    blocks: int
    tile_rows: int
    box_rows: int
    box_vecs: int

    def columns(self, block: int) -> list[int]:
        """The output columns ``block`` owns (every half)."""
        half = self.n // self.halves
        v0, v1 = block * self.nv, min((block + 1) * self.nv, half // self.vec)
        return [h * half + c for h in range(self.halves) for c in range(v0 * self.vec, max(v0, v1) * self.vec)]


class CpFramePlan(NamedTuple):
    """The launch plan of the frame kernel: ``grid`` co-resident blocks of
    ``CP_FRAME_THREADS`` threads, each with ``smem_bytes`` of dynamic shared
    memory: a ring of ``CP_FRAME_STAGES`` tiles of ``stage_bytes``, then the
    regions at the byte offsets ``regions`` (the staged matmul inputs, the
    column reduction, the column sums, the block's own columns of x, the
    attention and argmax scratch); and each projection's ownership
    (``projs``; no "mtp" entry without the mtp projection)."""

    grid: int
    stage_bytes: int
    regions: dict
    smem_bytes: int
    projs: dict

    def ints(self, cfg) -> list[int]:
        """The dims and the plan as the kernel's C entry takes them."""
        sc = cfg.layer_stack()
        dims = [sc.num_layers, sc.hidden_size, sc.num_heads, sc.num_kv_heads, sc.head_dim, sc.intermediate_size,
                cfg.vocab_size, cfg.embed_dim, cfg.num_acoustic, int("mtp" in self.projs)]
        per = []
        for name in CP_FRAME_PROJS:
            p = self.projs.get(name)
            per += [p.nv, p.blocks, p.tile_rows, p.box_rows, p.box_vecs] if p else [1, 0, 1, 1, 1]
        return dims + [self.grid, self.stage_bytes, *self.regions.values(), self.smem_bytes] + per


def cp_frame_plan(cfg, weight_kind: str, dtype: torch.dtype | None = None, sms: int = 132) -> CpFramePlan:
    """The frame kernel's launch plan for code predictor ``cfg`` with
    ``weight_kind`` ("float32", "bfloat16" or "int8") layer projections and
    heads, activations in ``dtype`` (default: the weights' type, bf16 for
    int8), on a card with ``sms`` SMs.

    Each projection's columns go to the fewest blocks that fit the card: a
    block owns ``nv`` vectors of 16 weight bytes (4 f32, 8 bf16 or 16 int8
    columns: a TMA box row holds at least 16 bytes), ``nv`` the smallest
    power of two that leaves at most ``sms`` owning blocks (a thread per
    vector: at most 256 a block). The grid is the most any projection uses
    (at least one block per q head, for attention). The rest of the shared
    memory (two staged input rows of the largest K, the column reduction
    and sums, the block's columns of x, attention scratch) is fixed by the
    shapes; the ring of ``CP_FRAME_STAGES`` tiles takes what is left of an
    H100 block's 232,448 bytes. A TMA box is the largest power of two of
    rows, at most 256, that divides K and fits a tile, each row the block's
    slice (in 256-column segments where it is wider); a tile is as many
    boxes as fit. Raises on shapes the kernel
    does not take.
    """
    if weight_kind not in _WEIGHT_KINDS:
        raise ValueError(f"cp_frame_plan: unknown weight kind {weight_kind!r}")
    if dtype is None:
        dtype = torch.bfloat16 if weight_kind == "int8" else _WEIGHT_KINDS[weight_kind]
    if dtype not in _DTYPES or (weight_kind != "int8" and dtype != _WEIGHT_KINDS[weight_kind]):
        raise ValueError(f"cp_frame_plan: {weight_kind} weights with {dtype} activations")
    sc = cfg.layer_stack()
    H, I, D, Hq, KV, L = (sc.hidden_size, sc.intermediate_size, sc.head_dim, sc.num_heads, sc.num_kv_heads,
                          sc.num_layers)
    G, V, E = cfg.num_acoustic, cfg.vocab_size, cfg.embed_dim
    qd, nqkv = Hq * D, (Hq + 2 * KV) * D
    if not (L >= 1 and G >= 1 and G + 1 <= CP_MAX_SEQ - 1 and 2 <= D <= CP_FRAME_THREADS and D % 2 == 0
            and KV >= 1 and Hq % KV == 0 and 1 <= Hq <= sms and min(H, I, V, E) >= 1):
        raise ValueError(f"cp_frame_plan: the kernel does not take {cfg}")
    t_vec = 4 if dtype == torch.float32 else 8
    w_vec = {"float32": 4, "bfloat16": 8, "int8": 16}[weight_kind]
    shapes = {"mtp": (E, H, 1), "qkv": (H, nqkv, 1), "o": (qd, H, 1), "gate_up": (H, 2 * I, 2), "down": (I, H, 1),
              "head": (H, V, 1)}
    if not cfg.needs_projection:
        del shapes["mtp"]
    owners = {}
    for name, (k, n, halves) in shapes.items():
        vec = t_vec if name == "mtp" else w_vec
        if (n // halves) % vec:
            raise ValueError(f"cp_frame_plan: {name} has {n // halves} columns, not a multiple of {vec}")
        nvec, nv = n // halves // vec, 1
        while -(-nvec // nv) > sms:
            nv *= 2
        if nv * halves > CP_FRAME_THREADS:
            raise ValueError(f"cp_frame_plan: {name} needs {nv} vectors a block on {sms} SMs")
        owners[name] = (k, n, halves, vec, nv, -(-nvec // nv))
    grid = max([Hq] + [o[-1] for o in owners.values()])
    # Each region holds two rows, in floats rounded up to 128 bytes.
    sizes = {
        "xs": max(o[0] for o in owners.values()),
        "red": max((8 if o[4] * o[2] < 32 else CP_FRAME_THREADS // (o[4] * o[2])) * o[4] * o[2] * o[3]
                   for o in owners.values()),
        "cs": max(o[4] * o[2] * o[3] for o in owners.values()),
        "own": owners["o"][4] * owners["o"][3],  # the block's own columns of x
    }
    rest = sum(-(-8 * n // 128) * 128 for n in sizes.values()) + 4 * CP_FRAME_MISC_FLOATS
    stage_bytes = (CP_FRAME_SMEM_LIMIT - rest) // CP_FRAME_STAGES // 128 * 128
    regions, at = {}, CP_FRAME_STAGES * stage_bytes
    for name, n in sizes.items():
        regions[name], at = at, at + -(-8 * n // 128) * 128
    regions["misc"] = at
    projs = {}
    for name, (k, n, halves, vec, nv, blocks) in owners.items():
        row_bytes = nv * halves * 16
        box_vecs = min(nv, CP_FRAME_BOX_COLUMNS // vec)
        if box_vecs < nv and (n // halves) % CP_FRAME_BOX_COLUMNS:
            raise ValueError(f"cp_frame_plan: {name}'s {n // halves} columns are no whole 256-column segments")
        box = 256
        while box > 1 and (k % box or box * row_bytes > stage_bytes):
            box //= 2
        if k % box or box * row_bytes > stage_bytes or box * nv * 16 % 128:
            raise ValueError(f"cp_frame_plan: {name}'s K {k} takes no TMA box of 128-byte-aligned rows")
        tile_rows = min(k, stage_bytes // row_bytes // box * box)
        projs[name] = CpProjPlan(k, n, halves, vec, nv, blocks, tile_rows, box, box_vecs)
    return CpFramePlan(grid, stage_bytes, regions, at + 4 * CP_FRAME_MISC_FLOATS, projs)


def _frame_leaves(params: dict) -> tuple:
    """The tensors the frame kernel reads, in a fixed order: weight and
    scale (None for plain weights) of qkv, o, gate|up, down and the heads;
    the four layer norms, the final norm, the embeddings, the mtp weight and
    bias (None without)."""
    layers = params["layers"]
    if "qkv_proj" not in layers or "gateup_proj" not in layers:
        raise ValueError("cp_frame: the kernel needs fused qkv_proj / gateup_proj weights")

    def parts(w):
        return (w["q8"], w["scale"]) if quant.is_quantized(w) else (w, None)

    mtp = params.get("mtp_proj")
    return (
        *parts(layers["qkv_proj"]), *parts(layers["o_proj"]), *parts(layers["gateup_proj"]),
        *parts(layers["down_proj"]), *parts(params["lm_heads"]),
        layers["input_ln"], layers["post_ln"], layers["q_norm"], layers["k_norm"], params["norm"],
        params["codec_embeddings"], None if mtp is None else mtp["w"], None if mtp is None else mtp["b"],
    )


class CpFramePack:
    """What the frame kernel needs of one parameter tree, checked and
    gathered once: the plan, the C entry's argument arrays, the weights' TMA
    descriptors, and a scratch that is zeroed once (its barrier count
    carries over from frame to frame) and serves one frame at a time.

    Its owner keeps it beside the tree (``pipeline.Qwen3TTS`` builds one on
    the card) and hands it to every ``cp_frame`` of that tree. The pack
    holds the tree's tensors, so the pointers in its descriptors stay valid
    while it lives. Its frames run on the stream of its first frame; a frame
    on another stream raises, since two frames must not share the scratch at
    once. A CUDA graph that captures frames replays on the pack's scratch,
    so frames outside the graph take a pack of their own.
    """

    def __init__(self, params: dict, cfg, dtype: torch.dtype, dev: torch.device | str):
        dev = torch.device(dev)
        if dev.type != "cuda" or dtype not in _DTYPES:
            raise ValueError(f"CpFramePack: the kernel runs on CUDA in float32 or bfloat16, not {dtype} on {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        leaves = _frame_leaves(params)
        sc = cfg.layer_stack()
        L, H, D, I = sc.num_layers, sc.hidden_size, sc.head_dim, sc.intermediate_size
        qd, kvd = sc.num_heads * D, sc.num_kv_heads * D
        G, V, E = cfg.num_acoustic, cfg.vocab_size, cfg.embed_dim
        layers = params["layers"]
        linears = {
            "qkv_proj": (layers["qkv_proj"], (L, H, qd + 2 * kvd)),
            "o_proj": (layers["o_proj"], (L, qd, H)),
            "gateup_proj": (layers["gateup_proj"], (L, H, 2 * I)),
            "down_proj": (layers["down_proj"], (L, I, H)),
            "lm_heads": (params["lm_heads"], (G, H, V)),
        }
        quantized = _check_linears(linears, dtype, dev, "cp_frame")
        for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
            _check(layers[name], name, shape, dtype, dev)
        _check(params["norm"], "norm", (H,), dtype, dev)
        _check(params["codec_embeddings"], "codec_embeddings", (G, V, E), dtype, dev)
        mtp = params.get("mtp_proj")
        if (mtp is not None) != cfg.needs_projection:
            raise ValueError("cp_frame: the kernel takes an mtp projection exactly when embed_dim != hidden_size")
        if mtp is not None:
            _check(mtp["w"], "mtp_proj.w", (E, H), dtype, dev)
            _check(mtp["b"], "mtp_proj.b", (H,), dtype, dev)
        if any(t is not None and t.data_ptr() % 16 for t in leaves):
            raise ValueError("cp_frame: every weight must be 16-byte aligned")
        kind = "int8" if quantized else {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
        self.plan = cp_frame_plan(cfg, kind, dtype, min(quant._sm_count(dev), 132))

        lib = _kernel_lib()
        ints = self.plan.ints(cfg)
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self.floats = (ctypes.c_float * 1)(sc.rms_norm_eps)
        self.scratch = torch.zeros(lib.q3_cp_frame_scratch_floats(self.ints), dtype=torch.float32, device=dev)
        rope = rope_tables(D, sc.rope_theta, CP_MAX_SEQ - 1, dev)
        qkv_w, qkv_s, o_w, o_s, gu_w, gu_s, down_w, down_s, heads_w, heads_s = leaves[:10]
        in_ln, post_ln, q_norm, k_norm, norm, etab, mtp_w, mtp_b = leaves[10:]
        ptrs = [etab, mtp_w, mtp_b, qkv_w, o_w, gu_w, down_w, heads_w, qkv_s, o_s, gu_s, down_s, heads_s,
                in_ln, post_ln, q_norm, k_norm, norm, *rope, self.scratch]
        self.ptrs = (ctypes.c_void_p * len(ptrs))(*[_ptr(t) for t in ptrs])
        self.maps = ctypes.create_string_buffer(lib.q3_cp_frame_maps_bytes())
        err = lib.q3_cp_frame_maps(_DTYPES[dtype], int(quantized), self.ints, self.ptrs, self.maps)
        if err != 0:
            raise RuntimeError(f"cp_frame: the weights' TMA descriptors were refused: CUDA error {err}")
        self.leaves = leaves
        self.key = (cfg, dtype, dev)
        self.quantized = quantized
        self.embed = E
        self.groups = G
        self.lib = lib
        self.stream = None  # the stream of the first frame

    def holds(self, params: dict, cfg, dtype: torch.dtype, dev: torch.device) -> bool:
        """Whether this pack was built for ``params`` (the same tensors) at
        this config, dtype and device."""
        return self.key == (cfg, dtype, dev) and all(a is b for a, b in zip(self.leaves, _frame_leaves(params)))


def cp_frame(
    params: dict,
    cfg,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
    pack: CpFramePack | None = None,
    trace: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """All acoustic codes of one frame: the CUDA kernel on a CUDA tensor (one
    launch), the plain version on a CPU tensor. Returns int32 [G] on the
    input's device; with ``trace`` (the card only) also the kernel's int64
    [grid, slots] phase stamps in ns (``cp_frame_trace_phases`` reads them).

    The kernel takes the fused stacked layer weights (``qkv_proj``,
    ``gateup_proj``; see ``models/weights.fuse_model_params``) in the
    inputs' dtype (float32 or bfloat16), or the int8 tree of
    ``quant.quantize_code_predictor_params`` (int8 layer projections and
    lm heads with f32 scales; everything else in the inputs' dtype); a tree
    the kernel does not take raises. ``pack``: the tree's ``CpFramePack``,
    which spares each frame the checks and the set-up; without one, the
    call builds a pack for itself.
    """
    dev = talker_hidden.device
    if dev.type == "cpu":
        return cp_frame_plain(params, cfg, talker_hidden, semantic_embed)
    if dev.type != "cuda":
        raise ValueError(f"cp_frame: no kernel for device {dev}")
    dtype = talker_hidden.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"cp_frame: unsupported dtype {dtype}")
    if pack is None:
        pack = CpFramePack(params, cfg, dtype, dev)
    elif not pack.holds(params, cfg, dtype, dev):
        raise ValueError("cp_frame: the pack was built for another tree, config, dtype or device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pack.stream is None:
        pack.stream = stream
    elif stream != pack.stream:
        raise RuntimeError(
            f"cp_frame: the pack's frames run on stream {pack.stream:#x}, not {stream:#x}; "
            "give each stream a pack of its own"
        )
    for name, t in (("talker_hidden", talker_hidden), ("semantic_embed", semantic_embed)):
        if t.device != dev or t.dtype != dtype or t.numel() != pack.embed or not t.is_contiguous():
            raise ValueError(
                f"cp_frame: {name} must be a contiguous {dtype} tensor of {pack.embed} values on {dev}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    codes = torch.empty(pack.groups, dtype=torch.int32, device=dev)
    stamps = None
    if trace:
        slots = pack.lib.q3_cp_frame_trace_slots(pack.ints)
        stamps = torch.zeros((pack.plan.grid, slots), dtype=torch.int64, device=dev)
    err = pack.lib.q3_cp_frame(
        _DTYPES[dtype], int(pack.quantized), pack.ints, pack.floats, pack.ptrs, pack.maps,
        talker_hidden.data_ptr(), semantic_embed.data_ptr(), codes.data_ptr(), _ptr(stamps), stream,
    )
    if err != 0:
        raise RuntimeError(f"cp_frame kernel launch failed: CUDA error {err}")
    cp_frame.launches += 1
    return (codes, stamps) if trace else codes


cp_frame.launches = 0  # frames the kernel ran (CPU-plain calls are not counted)


def _phase_sums(stamps: torch.Tensor, kinds: list) -> dict:
    """Sums of a traced launch's phases (``kinds``: the kind of each phase,
    in order) in µs: ``span`` from the first block's first stamp to the last
    leave; per kind, ``work`` from the phase's start (the previous barrier's
    last leave) to its last arrival, of which ``stage`` to the last block's
    work start and ``tiles`` the longest work (a GEMV's tile loop, or
    attention), and ``barrier`` from the last arrival to the last leave."""
    st = stamps.cpu().double().reshape(stamps.shape[0], -1, 4) / 1e3  # [blocks, phases, 4] in µs
    out = {k: {"work": 0.0, "stage": 0.0, "tiles": 0.0, "barrier": 0.0, "phases": 0} for k in dict.fromkeys(kinds)}
    begin = st[:, 0][st[:, 0] > 0].min().item()
    prev = begin
    for i in range(st.shape[1]):
        start, end, arrive, leave = (st[:, i, k] for k in range(4))
        kind = out[kinds[i % len(kinds)]]
        kind["phases"] += 1
        kind["work"] += arrive.max().item() - prev
        if (start > 0).any():
            kind["stage"] += start[start > 0].max().item() - prev
            kind["tiles"] += (end - start)[start > 0].max().item()
        kind["barrier"] += leave.max().item() - arrive.max().item()
        prev = leave.max().item()
    return {"span": prev - begin, **out}


def cp_frame_trace_phases(stamps: torch.Tensor, cfg) -> dict:
    """Where a traced frame's time went, from ``cp_frame(..., trace=True)``'s
    stamps, in µs summed over the frame's phases (each phase: the blocks
    between two barriers), by phase kind (mtp, qkv, attention, o, gate_up,
    down, head): see ``_phase_sums``."""
    layers = cfg.layer_stack().num_layers
    kinds = (["mtp"] if cfg.needs_projection else []) + ["qkv", "attention", "o", "gate_up", "down"] * layers + ["head"]
    return _phase_sums(stamps, kinds)


# ---------------------------------------------------------------------------
# The talker decode step (int8 or plain weights)
# ---------------------------------------------------------------------------


def _fused_dims_tile(layers: dict, hidden: int) -> bool:
    """Every fused dim (qkv N, o K, gate|up N, down K) a multiple of ``hidden``."""

    def mat(p):
        w = layers[p]
        return w["q8"] if quant.is_quantized(w) else w

    dims = (
        mat("qkv_proj").shape[-1],
        mat("o_proj").shape[-2],
        mat("gateup_proj").shape[-1],
        mat("down_proj").shape[-2],
    )
    return all(d % hidden == 0 for d in dims)


def _acc(x: torch.Tensor, w, k0: int = 0, k1: int | None = None) -> torch.Tensor:
    """f32 sum of x @ w[k0:k1], x rounded to the matmul input type: bf16
    for an int8 linear (exact products, before the scale), the weights' own
    dtype for a plain one."""
    if quant.is_quantized(w):
        return x.to(torch.bfloat16).float() @ w["q8"][k0:k1].float()
    return x.to(w.dtype).float() @ w[k0:k1].float()


def _mm_out(x: torch.Tensor, w, dtype: torch.dtype, k_chunk: int | None) -> torch.Tensor:
    """round_T(acc [* scale]): acc one whole dot (``k_chunk`` None) or the
    sum over ``k_chunk``-wide K chunks in ascending order; an int8 linear's
    scale applied to the finished sum."""
    if k_chunk is None:
        acc = _acc(x, w)
    else:
        acc = None
        for k0 in range(0, x.shape[-1], k_chunk):
            part = _acc(x[:, k0 : k0 + k_chunk], w, k0, k0 + k_chunk)
            acc = part if acc is None else acc + part
    return (acc * w["scale"] if quant.is_quantized(w) else acc).to(dtype)


def talker_step_plain(
    layers: dict, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int
) -> torch.Tensor:
    """One batch-1 decode step through every layer, plain, on the fused
    tree with int8 or plain (T) projections.

    x: [1, 1, H] in the compute dtype T (f32 or bf16); ck, cv: [L, S, KV*D]
    caches in T, whose row ``pos`` of every layer is written in place.
    Returns the last layer's output [1, 1, H] (before the final norm).
    Rounding points (those of the JAX kernel, ``quantized`` True or False):
    projection inputs bf16 (int8) or T (plain); qkv = round_T(acc [*
    scale]); QK-norm and RoPE in T; scores f32 with the softmax over rows <=
    pos, unnormalised weights rounded to T before the value sum; the
    attention output rounded to the matmul input type before o; o and down
    summed over H-wide K chunks in ascending order [times the scale],
    rounded to T; gate|up rounded to T, SiLU in f32. One point differs for
    int8 at T = f32: the JAX kernel rounds q to bf16 for its scores, while
    this version (and the kernel) keep q in T, as the JAX package's layer
    scan does; plain weights keep q in T in both.
    """
    dt = x.dtype
    H, D = cfg.hidden_size, cfg.head_dim
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    qd, kvd, inter = hq * D, kv * D, cfg.intermediate_size
    eps = cfg.rms_norm_eps
    inv_freq = nn.rope_inv_freq(D, cfg.rope_theta, device=x.device)
    cos, sin = nn.rope_cos_sin(torch.tensor([pos], dtype=torch.float32, device=x.device), inv_freq)
    scale = 1.0 / (D**0.5)
    h = x.reshape(1, H)
    for l in range(ck.shape[0]):
        layer = nn.layer_params_at(layers, l)
        qkv = _mm_out(nn.rms_norm(h, layer["input_ln"], eps), layer["qkv_proj"], dt, None)
        q = nn.rms_norm(qkv[:, :qd].reshape(1, hq, D), layer["q_norm"], eps)
        k = nn.rms_norm(qkv[:, qd : qd + kvd].reshape(1, kv, D), layer["k_norm"], eps)
        q = nn.apply_rope(q, cos, sin)[0]  # [hq, D]
        k = nn.apply_rope(k, cos, sin)[0]
        ck[l, pos] = k.reshape(kvd)
        cv[l, pos] = qkv[0, qd + kvd :]

        keys = ck[l, : pos + 1].reshape(pos + 1, kv, D).float()
        vals = cv[l, : pos + 1].reshape(pos + 1, kv, D).float()
        qg = q.float().reshape(kv, hq // kv, D)
        s = torch.einsum("kgd,skd->kgs", qg, keys) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pv = torch.einsum("kgs,skd->kgd", p.to(dt).float(), vals)
        attn = (pv / p.sum(dim=-1, keepdim=True)).reshape(1, qd)
        h = h + _mm_out(attn, layer["o_proj"], dt, H)

        gu = _mm_out(nn.rms_norm(h, layer["post_ln"], eps), layer["gateup_proj"], dt, None)
        act = F.silu(gu[:, :inter].float()).to(dt) * gu[:, inter:]
        h = h + _mm_out(act, layer["down_proj"], dt, H)
    return h.reshape(1, 1, H)


def _layer_stack(cfg):
    """The layer-stack config of a talker config, or the layer-stack config itself."""
    return cfg.layer_stack() if hasattr(cfg, "layer_stack") else cfg


# Kernel 3's constants (csrc/talker_step.cu, kernel 7's too): ring stages,
# the attention chunks of a head (at most; rows each at least: the most rows
# the normalised form takes), the widest head (kernel 3's; the normalised
# form's), the most q heads, the attention scratch's fixed floats. The plan
# lays out the block's shared memory; the kernel takes the offsets and
# checks them.
TALKER_STEP_STAGES = 4
TALKER_STEP_MAX_CHUNKS = 8
TALKER_STEP_CHUNK_ROWS = 256
TALKER_STEP_MAX_HEAD_DIM = 128
TALKER_STEP_NORM_MAX_HEAD_DIM = 256
TALKER_STEP_MAX_HEADS = 128
TALKER_STEP_MISC_FIXED = 4096
# The projections in the order a layer runs them (the kernel's enum StepProj).
TALKER_STEP_PROJS = ("qkv", "o", "gate_up", "down")


class TalkerProjPlan(NamedTuple):
    """One projection of the talker step kernel: ``k`` input rows, ``n``
    output columns (the row stride) in ``halves`` halves (2 for gate|up: a
    group holds the same columns of both, so its block finishes SiLU*up),
    summed in fixed-order chunks of ``chunk`` rows (H for o and down, as
    the plain version sums them; the whole K for qkv and gate|up), cut into
    vectors of ``vec`` columns (16 bytes of weights). Block g streams and
    owns column group g: vectors [g*nv, min((g+1)*nv, n/halves/vec)) of
    each half, over the whole K; ``groups`` blocks own any. A ring tile
    holds ``tile_rows`` K rows of a block's slice (never across a chunk),
    loaded as TMA boxes of ``box_rows`` rows."""

    k: int
    n: int
    halves: int
    chunk: int
    vec: int
    nv: int
    groups: int
    tile_rows: int
    box_rows: int

    def columns(self, group: int) -> list[int]:
        """The output columns of column group ``group`` (every half)."""
        half = self.n // self.halves
        v0, v1 = group * self.nv, min((group + 1) * self.nv, half // self.vec)
        return [h * half + c for h in range(self.halves) for c in range(v0 * self.vec, max(v0, v1) * self.vec)]


class TalkerStepPlan(NamedTuple):
    """The launch plan of the talker step kernel: ``grid`` co-resident
    blocks of 256 threads, each with ``smem_bytes`` of dynamic shared
    memory: a ring of ``TALKER_STEP_STAGES`` tiles of ``stage_bytes``, then
    the regions at the byte offsets ``regions`` (the staged matmul input,
    the column reduction, the column sums, the attention scratch); and each
    projection's column groups (``projs``)."""

    grid: int
    stage_bytes: int
    regions: dict
    smem_bytes: int
    projs: dict

    def ints(self, cfg, max_seq: int) -> list[int]:
        """The dims and the plan as the kernel's C entry takes them."""
        sc = _layer_stack(cfg)
        dims = [sc.num_layers, sc.hidden_size, sc.num_heads, sc.num_kv_heads, sc.head_dim, sc.intermediate_size,
                max_seq]
        per = [v for name in TALKER_STEP_PROJS for v in (
            self.projs[name].nv, self.projs[name].groups, self.projs[name].tile_rows, self.projs[name].box_rows)]
        return dims + [self.grid, self.stage_bytes, *self.regions.values(), self.smem_bytes] + per


def _reduce_groups(nvt: int) -> int:
    """Row lanes the kernel's column reduction keeps for ``nvt`` vectors."""
    return CP_FRAME_THREADS // 32 if nvt < 32 and nvt & (nvt - 1) == 0 else CP_FRAME_THREADS // nvt


def talker_step_plan(
    cfg, weight_kind: str, dtype: torch.dtype | None = None, sms: int = 132,
    max_seq: int = TALKER_STREAM_MAX_SEQ, normalised: bool = False,
) -> TalkerStepPlan:
    """The talker step kernel's launch plan for talker ``cfg`` (a talker or
    layer-stack config) with ``weight_kind`` ("float32", "bfloat16" or
    "int8") projections, activations in ``dtype`` (default: the weights'
    type, bf16 for int8), caches of at most ``max_seq`` rows, on a card with
    ``sms`` SMs. ``normalised``: the plan of kernel 7 (the code predictor's
    step, the same body in its normalised form), whose heads attend in one
    chunk (at most ``TALKER_STEP_CHUNK_ROWS`` cache rows) and may be up to
    256 wide (kernel 3's: 128).

    Each projection's columns go to as many blocks as the card has SMs: a
    block owns ``nv`` vectors of 16 weight bytes (of each half), the fewest
    that leave at most ``sms`` groups and whose TMA box rows land 128-byte
    aligned, over the whole K. So every SM streams a slice of every
    projection, and at any moment the blocks read neighbouring columns of
    the same K rows (on an H100 faster than K parts of wider rows, whose
    sums another block must add: PERF.md). The grid is the most any
    projection uses (at least one block per q head). The staged input (the
    widest K), the column reduction and sums (two rows) and the attention
    scratch (its chunk's scores: the most rows a chunk holds below
    ``max_seq``) are fixed by the shapes; the ring takes what is left of an
    H100 block's 232,448 bytes. A TMA box is the largest power of two of
    rows, at most 256, that divides the projection's chunk, lands 128-byte
    aligned and fits a tile; a tile is the most boxes that fit and divide
    the chunk. Raises on shapes the kernel does not take.
    """
    if weight_kind not in _WEIGHT_KINDS:
        raise ValueError(f"talker_step_plan: unknown weight kind {weight_kind!r}")
    if dtype is None:
        dtype = torch.bfloat16 if weight_kind == "int8" else _WEIGHT_KINDS[weight_kind]
    if dtype not in _DTYPES or (weight_kind != "int8" and dtype != _WEIGHT_KINDS[weight_kind]):
        raise ValueError(f"talker_step_plan: {weight_kind} weights with {dtype} activations")
    sc = _layer_stack(cfg)
    H, I, D, Hq, KV, L = (sc.hidden_size, sc.intermediate_size, sc.head_dim, sc.num_heads, sc.num_kv_heads,
                          sc.num_layers)
    qd, nqkv = Hq * D, (Hq + 2 * KV) * D
    t_vec = 4 if dtype == torch.float32 else 8
    w_vec = {"float32": 4, "bfloat16": 8, "int8": 16}[weight_kind]
    max_d = TALKER_STEP_NORM_MAX_HEAD_DIM if normalised else TALKER_STEP_MAX_HEAD_DIM
    if not (L >= 1 and 2 <= D <= max_d and D % t_vec == 0 and KV >= 1 and Hq % KV == 0
            and 1 <= Hq <= min(sms, TALKER_STEP_MAX_HEADS) and min(H, I) >= 1 and qd % H == 0 and I % H == 0
            and 1 <= max_seq <= (TALKER_STEP_CHUNK_ROWS if normalised else max_seq)):
        raise ValueError(f"talker_step_plan: the kernel does not take {sc} with {max_seq} cache rows")
    shapes = {"qkv": (H, nqkv, 1, H), "o": (qd, H, 1, H), "gate_up": (H, 2 * I, 2, H), "down": (I, H, 1, H)}
    chosen = {}
    for name, (k, n, halves, chunk) in shapes.items():
        if (n // halves) % w_vec:
            raise ValueError(f"talker_step_plan: {name} has {n // halves} columns, not a multiple of {w_vec}")
        nvec = n // halves // w_vec
        nv = -(-nvec // sms)
        while nv * halves <= CP_FRAME_THREADS and nv * w_vec <= CP_FRAME_BOX_COLUMNS and chunk % (8 // math.gcd(nv, 8)):
            nv += 1
        if nv * halves > CP_FRAME_THREADS or nv * w_vec > CP_FRAME_BOX_COLUMNS:
            raise ValueError(f"talker_step_plan: {name} ({k} x {n}) takes no column groups on {sms} SMs")
        chosen[name] = (k, n, halves, chunk, nv, -(-nvec // nv))
    grid = max([Hq] + [c[5] for c in chosen.values()])
    chunk_rows = max(TALKER_STEP_CHUNK_ROWS, -(-max_seq // min(TALKER_STEP_MAX_CHUNKS, grid // Hq)))
    floats = {
        "xs": max(c[0] for c in chosen.values()),
        "red": max(_reduce_groups(c[4] * c[2]) * c[4] * c[2] * w_vec for c in chosen.values()),
        "cs": 2 * max(c[4] * c[2] * w_vec for c in chosen.values()),
        "misc": TALKER_STEP_MISC_FIXED + -(-chunk_rows // 32) * 32,
    }
    nbytes = {name: -(-4 * f // 128) * 128 for name, f in floats.items()}
    stage_bytes = (CP_FRAME_SMEM_LIMIT - sum(nbytes.values())) // TALKER_STEP_STAGES // 128 * 128
    regions, at = {}, TALKER_STEP_STAGES * stage_bytes
    for name, size in nbytes.items():
        regions[name], at = at, at + size
    projs = {}
    for name, (k, n, halves, chunk, nv, groups) in chosen.items():
        row_bytes = nv * halves * 16
        box = 256
        while box > 1 and (chunk % box or box * row_bytes > stage_bytes):
            box //= 2
        if chunk % box or box * row_bytes > stage_bytes or box * nv * 16 % 128:
            raise ValueError(f"talker_step_plan: {name}'s {chunk}-row chunks take no TMA box of 128-byte-aligned rows")
        tile_rows = min(chunk, stage_bytes // row_bytes // box * box)
        while chunk % tile_rows:
            tile_rows -= box
        projs[name] = TalkerProjPlan(k, n, halves, chunk, w_vec, nv, groups, tile_rows, box)
    return TalkerStepPlan(grid, stage_bytes, regions, at, projs)


def _talker_leaves(layers: dict) -> tuple:
    """The tensors the talker step kernel reads, in a fixed order: weight
    and scale (None for plain weights) of qkv, o, gate|up and down; the four
    layer norms."""
    if "qkv_proj" not in layers or "gateup_proj" not in layers:
        raise ValueError("talker_step: the kernel needs fused qkv_proj / gateup_proj weights")

    def parts(w):
        return (w["q8"], w["scale"]) if quant.is_quantized(w) else (w, None)

    return (*(t for name in _PROJS for t in parts(layers[name])),
            layers["input_ln"], layers["post_ln"], layers["q_norm"], layers["k_norm"])


def _checked_stack(layers: dict, sc, dtype: torch.dtype, dev: torch.device, op: str) -> tuple:
    """The tensors a whole-stack kernel reads of the fused tree ``layers``
    (``_talker_leaves``), each checked against the layer-stack config
    ``sc``: [L, K, N] projections all int8 (f32 [L, N] scales) or all plain
    in ``dtype``, the four norms in ``dtype``, on ``dev``, contiguous and
    16-byte aligned. Returns (leaves, whether the projections are int8)."""
    leaves = _talker_leaves(layers)
    L, H, D, I = sc.num_layers, sc.hidden_size, sc.head_dim, sc.intermediate_size
    qd, kvd = sc.num_heads * D, sc.num_kv_heads * D
    linears = {"qkv_proj": (L, H, qd + 2 * kvd), "o_proj": (L, qd, H), "gateup_proj": (L, H, 2 * I),
               "down_proj": (L, I, H)}
    quantized = _check_linears({n: (layers[n], shape) for n, shape in linears.items()}, dtype, dev, op)
    for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
        _check(layers[name], name, shape, dtype, dev, op)
    if any(t is not None and t.data_ptr() % 16 for t in leaves):
        raise ValueError(f"{op}: every weight must be 16-byte aligned")
    return leaves, quantized


def supports_talker_step_kernel(layers: dict, cfg, max_seq: int) -> bool:
    """Whether the talker step kernel takes this fused tree (all int8 or all
    plain) with caches of up to ``max_seq`` rows: ``talker_step_plan`` on
    an H100's 132 SMs; a tree it refuses takes the layer path."""
    qkv = layers.get("qkv_proj")
    if qkv is None or "input_ln" not in layers:
        return False
    dtype = layers["input_ln"].dtype
    kind = "int8" if quant.is_quantized(qkv) else {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(qkv.dtype)
    if kind is None:
        return False
    try:
        talker_step_plan(cfg, kind, dtype, max_seq=max_seq)
    except ValueError:
        return False
    return True


class TalkerStepPack:
    """What the talker step kernel needs of one fused talker tree, checked
    and gathered once: the plan, the C entry's argument arrays, the
    weights' TMA descriptors, the RoPE tables for ``max_seq`` rows, and a
    scratch that is zeroed once (its barrier count and flags carry over from
    step to step) and serves one step at a time.

    Its owner keeps it beside the tree (``pipeline.Qwen3TTS`` builds one on
    the card) and hands it to every ``talker_step`` of that tree, with any
    cache of at most ``max_seq`` rows. The pack holds the tree's tensors, so
    the pointers in its descriptors stay valid while it lives. Its steps run
    on the stream of its first step; a step on another stream raises, since
    two steps must not share the scratch at once. A CUDA graph that captures
    steps replays on the pack's scratch, so steps outside the graph take a
    pack of their own.
    """

    normalised = False  # kernel 3's form (CpStepPack: kernel 7's)

    def __init__(self, layers: dict, cfg, dtype: torch.dtype, dev: torch.device | str,
                 max_seq: int = TALKER_STREAM_MAX_SEQ):
        op = "streamed_decode_step" if self.normalised else "talker_step"
        dev = torch.device(dev)
        if dev.type != "cuda" or dtype not in _DTYPES:
            raise ValueError(f"{type(self).__name__}: the kernel runs on CUDA in float32 or bfloat16, not {dtype} "
                             f"on {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        sc = _layer_stack(cfg)
        leaves, quantized = _checked_stack(layers, sc, dtype, dev, op)
        if self.normalised and not quantized:
            raise ValueError(f"{op}: the kernel takes int8 weights only")
        kind = "int8" if quantized else {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
        self.plan = talker_step_plan(sc, kind, dtype, min(quant._sm_count(dev), 132), max_seq, self.normalised)

        lib = _kernel_lib()
        ints = self.plan.ints(sc, max_seq)
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self.floats = (ctypes.c_float * 1)(sc.rms_norm_eps)
        self.scratch = torch.zeros(lib.q3_talker_step_scratch_floats(self.ints), dtype=torch.float32, device=dev)
        # Kernel 3 reads the pack's RoPE tables; kernel 7 the caller's.
        self.rope = (None, None) if self.normalised else rope_tables(sc.head_dim, sc.rope_theta, max_seq, dev)
        qkv_w, qkv_s, o_w, o_s, gu_w, gu_s, down_w, down_s, in_ln, post_ln, q_norm, k_norm = leaves
        ptrs = [qkv_w, o_w, gu_w, down_w, qkv_s, o_s, gu_s, down_s, in_ln, post_ln, q_norm, k_norm, *self.rope,
                self.scratch]
        self.ptrs = (ctypes.c_void_p * len(ptrs))(*[_ptr(t) for t in ptrs])
        self.maps = ctypes.create_string_buffer(lib.q3_talker_step_maps_bytes())
        err = lib.q3_talker_step_maps(_DTYPES[dtype], int(quantized), self.ints, self.ptrs, self.maps)
        if err != 0:
            raise RuntimeError(f"{op}: the weights' TMA descriptors were refused: CUDA error {err}")
        self.leaves = leaves
        self.key = (sc, dtype, dev)
        self.quantized = quantized
        self.max_seq = max_seq
        self.lib = lib
        self.stream = None  # the stream of the first step

    def holds(self, layers: dict, cfg, dtype: torch.dtype, dev: torch.device) -> bool:
        """Whether this pack was built for ``layers`` (the same tensors) at
        this config, dtype and device."""
        return self.key == (_layer_stack(cfg), dtype, dev) and all(
            a is b for a, b in zip(self.leaves, _talker_leaves(layers)))


class CpStepPack(TalkerStepPack):
    """Kernel 7's ``TalkerStepPack``: one fused int8 code-predictor layer
    stack, checked and gathered once, with caches of up to ``max_seq`` rows
    (at most ``TALKER_STEP_CHUNK_ROWS``), for ``streamed_decode_step`` (the
    same body in its normalised form; the RoPE tables are the caller's).
    Kept and handed down like a ``TalkerStepPack`` (``pipeline.Qwen3TTS``
    builds one on the card when the code predictor takes the
    "streamed_step" route)."""

    normalised = True

    def __init__(self, layers: dict, cfg, dtype: torch.dtype, dev: torch.device | str, max_seq: int = CP_MAX_SEQ):
        super().__init__(layers, cfg, dtype, dev, max_seq)


def _launch_step(
    pack: TalkerStepPack, op: str, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int,
    trace: bool, tables: tuple = (),
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel 3, or of kernel 7 (a ``CpStepPack``, with the
    caller's RoPE ``tables``), through ``pack`` after the checks they share:
    the caches, pos, the pack's rows and stream, x."""
    dev, dtype = x.device, x.dtype
    sc = _layer_stack(cfg)
    H, kvd, L = sc.hidden_size, sc.num_kv_heads * sc.head_dim, sc.num_layers
    S = ck.shape[1] if ck.dim() == 3 else 0
    for name, c in (("cache k", ck), ("cache v", cv)):
        _check(c, name, (L, S, kvd), dtype, dev, op)
        if c.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")
    if not 0 <= pos < S:
        raise ValueError(f"{op}: pos {pos} outside the {S}-row cache")
    if S > pack.max_seq:
        raise ValueError(f"{op}: a {S}-row cache; the pack takes at most {pack.max_seq} rows")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pack.stream is None:
        pack.stream = stream
    elif stream != pack.stream:
        raise RuntimeError(
            f"{op}: the pack's steps run on stream {pack.stream:#x}, not {stream:#x}; "
            "give each stream a pack of its own"
        )
    if x.numel() != H or not x.is_contiguous():
        raise ValueError(f"{op}: x must be a contiguous {dtype} tensor of {H} values on {dev}; "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    y = torch.empty(H, dtype=dtype, device=dev)
    stamps = None
    if trace:
        slots = pack.lib.q3_talker_step_trace_slots(pack.ints)
        stamps = torch.zeros((pack.plan.grid, slots), dtype=torch.int64, device=dev)
    args = (x.data_ptr(), y.data_ptr(), ck.data_ptr(), cv.data_ptr())
    if pack.normalised:
        err = pack.lib.q3_cp_step(_DTYPES[dtype], pack.ints, pack.floats, pack.ptrs, pack.maps, *args,
                                  *(t.data_ptr() for t in tables), S, pos, _ptr(stamps), stream)
    else:
        err = pack.lib.q3_talker_step(_DTYPES[dtype], int(pack.quantized), pack.ints, pack.floats, pack.ptrs,
                                      pack.maps, *args, S, pos, _ptr(stamps), stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    y = y.reshape(1, 1, H)
    return (y, stamps) if trace else y


def talker_step(
    layers: dict, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int,
    pack: TalkerStepPack | None = None, trace: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """One talker decode step: the CUDA kernel on a CUDA tensor (one
    launch), the plain version on a CPU tensor (arguments and result as
    ``talker_step_plain``); with ``trace`` (the card only) also the
    kernel's int64 [grid, slots] phase stamps in ns
    (``talker_step_trace_phases`` reads them).

    The kernel takes the canonical fused tree with all four projections
    int8 (``[L, K, N]`` int8 with ``[L, N]`` f32 scales) or all plain in x's
    dtype (``[L, K, N]``); norms and caches in x's dtype. A mixed tree
    raises. ``pack``: the tree's ``TalkerStepPack``, which spares each step
    the checks and the set-up; without one, the call builds a pack for
    itself (for this cache's rows).
    """
    dev = x.device
    if dev.type == "cpu":
        return talker_step_plain(layers, x, cfg, ck, cv, pos)
    if dev.type != "cuda":
        raise ValueError(f"talker_step: no kernel for device {dev}")
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"talker_step: unsupported dtype {dtype}")
    sc = _layer_stack(cfg)
    if pack is None:
        pack = TalkerStepPack(layers, sc, dtype, dev, max_seq=ck.shape[1] if ck.dim() == 3 else 0)
    elif pack.normalised or not pack.holds(layers, sc, dtype, dev):
        raise ValueError("talker_step: the pack was built for another tree, config, dtype or device")
    out = _launch_step(pack, "talker_step", x, sc, ck, cv, pos, trace)
    talker_step.launches += 1
    return out


talker_step.launches = 0  # steps the kernel ran, either form (CPU-plain calls are not counted)


def talker_step_trace_phases(stamps: torch.Tensor, cfg) -> dict:
    """Where a traced step's time went, from ``talker_step(..., trace=True)``'s
    stamps, in µs summed over the step's phases by kind (qkv, attention, o,
    gate_up, down; see ``_phase_sums``: ``tiles`` is a GEMV's tile loop, or
    the attention itself), and each kind's ``epilogue``: its work after
    staging and the longest work (the columns finished and written)."""
    kinds = ["qkv", "attention", "o", "gate_up", "down"] * _layer_stack(cfg).num_layers
    out = _phase_sums(stamps, kinds)
    for kind in TALKER_STEP_PROJS[:1] + ("attention",) + TALKER_STEP_PROJS[1:]:
        k = out[kind]
        k["epilogue"] = k["work"] - k["stage"] - k["tiles"]
    return out


# ---------------------------------------------------------------------------
# The per-step int8 code predictor: the fused attention and MLP sub-layer
# steps (kernels 5 and 6), the whole decode step (kernel 7), and the gates
# that pick between them and the whole-frame kernel.
# ---------------------------------------------------------------------------


def supports_fused_step(layers: dict) -> bool:
    """The JAX gate (``fused_layer.supports_fused_step``): the fused tree
    with all four layer projections int8."""
    return "qkv_proj" in layers and all(quant.is_quantized(layers.get(p)) for p in _PROJS)


def has_stream_pack(layers: dict, hidden: int) -> bool:
    """The gate of the JAX ``make_stream_pack`` on this layer stack: a fused
    tree, all int8 or all plain (f32 / bf16), whose dims tile by ``hidden``.
    The port holds no pack: the whole-step kernels (1, 3, 7) read the fused
    tree itself, so the tree's form is the gate."""
    if "qkv_proj" not in layers:
        return False
    flags = {quant.is_quantized(layers.get(p)) for p in _PROJS}
    return len(flags) == 1 and _fused_dims_tile(layers, hidden)


def supports_cp_frame_kernel(params: dict, cfg) -> bool:
    """The JAX gate of the whole-frame kernel (``supports_cp_frame_kernel``)
    given the pack the JAX package would hold (``has_stream_pack``): stacked
    lm heads, at most 15 acoustic groups, an even embedding vocab; and the
    port's kernel must take the shapes (``cp_frame_plan`` on an H100's 132
    SMs), else the tree takes the per-step or the layer path."""
    if not has_stream_pack(params["layers"], cfg.hidden_size):
        return False
    heads = params.get("lm_heads")
    if not (quant.is_quantized(heads) or getattr(heads, "ndim", 0) == 3):
        return False
    if cfg.num_acoustic + 1 > 16 or params["codec_embeddings"].shape[1] % 2:
        return False
    dtype = params["norm"].dtype
    kind = "int8" if quant.is_quantized(heads) else {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(dtype)
    try:
        cp_frame_plan(cfg, kind, dtype)
    except ValueError:
        return False
    return True


def _attention_plain(
    x, layer, cos_row, sin_row, ck, cv, pos, heads, kv_heads, head_dim, eps, residual, k_chunk
) -> torch.Tensor:
    """The attention sub-layer of kernels 5 and 7, plain. x: [1, H] in T;
    cos_row/sin_row: [1, D/2] already rounded to the kernel's RoPE type;
    ck, cv: [S, KV*D] in T, row ``pos`` written in place, rows > pos unread."""
    dt = x.dtype
    qd, kvd = heads * head_dim, kv_heads * head_dim
    qkv = _mm_out(nn.rms_norm(x, layer["input_ln"], eps), layer["qkv_proj"], dt, None)
    q = nn.rms_norm(qkv[:, :qd].reshape(1, heads, head_dim), layer["q_norm"], eps)
    k = nn.rms_norm(qkv[:, qd : qd + kvd].reshape(1, kv_heads, head_dim), layer["k_norm"], eps)
    q = nn.apply_rope(q, cos_row, sin_row)[0]  # [heads, D]
    k = nn.apply_rope(k, cos_row, sin_row)[0]
    ck[pos] = k.reshape(kvd).to(ck.dtype)
    cv[pos] = qkv[0, qd + kvd :].to(cv.dtype)

    keys = ck[: pos + 1].reshape(pos + 1, kv_heads, head_dim).float()
    vals = cv[: pos + 1].reshape(pos + 1, kv_heads, head_dim).float()
    qg = q.float().reshape(kv_heads, heads // kv_heads, head_dim)
    s = torch.einsum("kgd,skd->kgs", qg, keys) * (1.0 / head_dim**0.5)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (p / p.sum(dim=-1, keepdim=True)).to(cv.dtype)  # normalised, then rounded
    out = torch.einsum("kgs,skd->kgd", w.float(), vals).to(dt)
    o = _mm_out(out.reshape(1, qd), layer["o_proj"], dt, k_chunk)
    return x + o if residual else o


def _mlp_plain(x, layer, intermediate, eps, residual, k_chunk) -> torch.Tensor:
    """The MLP sub-layer of kernels 6 and 7, plain (x: [1, H] in T)."""
    dt = x.dtype
    gu = _mm_out(nn.rms_norm(x, layer["post_ln"], eps), layer["gateup_proj"], dt, None)
    g = gu[:, :intermediate].float()
    silu = (g * (1.0 / (1.0 + torch.exp(-g)))).to(dt)
    down = _mm_out(silu * gu[:, intermediate:], layer["down_proj"], dt, k_chunk)
    return x + down if residual else down


def fused_attention_step_plain(
    x, layer, cos_t, sin_t, ck, cv, pos: int, heads: int, kv_heads: int, head_dim: int, eps: float,
    residual: bool = True,
) -> torch.Tensor:
    """Kernel 5 in plain PyTorch: one int8 attention sub-layer step.

    x: [1, H] in T (f32 or bf16); ``layer``: one layer's fused int8 weights
    and T norms; cos_t/sin_t: [>= pos+1, D/2] f32 RoPE tables; ck, cv: [S,
    KV*D] in T, row ``pos`` written in place. Returns x + o (``residual``)
    or o alone (the tensor-parallel partial). Rounding points of the JAX
    kernel: the normed input and the attention output bf16 into their
    matmuls; qkv = round_T(acc * scale); QK-norm in f32 rounded to T; RoPE in
    T with cos/sin rounded to T; scores f32 over rows <= pos, the normalised
    softmax weights rounded to the cache dtype; o one whole dot * scale.
    """
    cos_row, sin_row = cos_t[pos : pos + 1], sin_t[pos : pos + 1]
    return _attention_plain(x, layer, cos_row, sin_row, ck, cv, pos, heads, kv_heads, head_dim, eps, residual, None)


def fused_mlp_step_plain(x, layer, intermediate: int, eps: float, residual: bool = True) -> torch.Tensor:
    """Kernel 6 in plain PyTorch: RMSNorm -> int8 gate|up (round_T) -> SiLU
    in f32 (round_T) * up -> int8 down (round_T) -> x + down, or down alone."""
    return _mlp_plain(x, layer, intermediate, eps, residual, None)


def streamed_decode_step_plain(layers: dict, x, cfg, ck, cv, pos: int, cos_t, sin_t) -> torch.Tensor:
    """Kernel 7 in plain PyTorch: one decode step through every layer.

    x: [1, 1, H] in T; ``layers``: the canonical fused int8 tree ([L, K, N]
    int8, [L, N] f32 scales); ck, cv: [L, S, KV*D] planes in T, row ``pos``
    of each written in place. Kernels 5 + 6 per layer, with the JAX whole-step
    kernel's differences: cos/sin rounded to bf16 (even when T is f32); o
    and down summed over H-wide K chunks in ascending order before the
    scale; the attention output rounded straight to bf16 (the value kernel
    5 gets through T, for T = f32 or bf16). Returns [1, 1, H].
    """
    H = cfg.hidden_size
    bf16 = torch.bfloat16
    cos_row, sin_row = cos_t[pos : pos + 1].to(bf16), sin_t[pos : pos + 1].to(bf16)
    h = x.reshape(1, H)
    for l in range(ck.shape[0]):
        layer = nn.layer_params_at(layers, l)
        h = _attention_plain(
            h, layer, cos_row, sin_row, ck[l], cv[l], pos, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.rms_norm_eps, True, H,
        )
        h = _mlp_plain(h, layer, cfg.intermediate_size, cfg.rms_norm_eps, True, H)
    return h.reshape(1, 1, H)


def _on_card(x: torch.Tensor, op: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA tensor
    of a dtype the kernels take; raises for anything else."""
    if x.is_cuda and x.dtype in _DTYPES:
        return True
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{op}: unsupported dtype {x.dtype}")
    return True


# Kernels 5 and 6's constants (csrc/fused_step.cu): ring stages, the
# attention chunks of a head (at most) and the rows a chunk holds (at
# least, unless fewer are live), the widest head, the attention scratch's
# fixed floats, the phases a call stamps. The plan lays out the block's
# shared memory; the kernels take the offsets and check them.
FUSED_STEP_STAGES = 4
FUSED_STEP_MAX_CHUNKS = 32
FUSED_STEP_CHUNK_ROWS = 64
FUSED_STEP_MAX_HEAD_DIM = 256
FUSED_STEP_MISC_FIXED = 4096
# The projections (the kernels' enum FsProj) and each sub-layer's phases.
FUSED_STEP_PROJS = ("qkv", "o", "gate_up", "down")
FUSED_STEP_PHASES = {"attention": ("qkv", "scores", "values", "o"), "mlp": ("gate_up", "down")}
# The int64 argument slots of a call (q3_fused_step_call): a pack fills the
# first five once, a call the rest with one slice.
FUSED_STEP_CALL_SLOTS = ("dtype", "ints", "floats", "ptrs", "maps", "kernel", "layer", "x", "y", "ck", "cv", "cos_t",
                         "sin_t", "seq", "pos", "residual", "trace", "stream")
_CALL_FIRST = FUSED_STEP_CALL_SLOTS.index("kernel")
_INT8_VEC = 16  # int8 columns of a 16-byte vector


class FusedStepPlan(NamedTuple):
    """The launch plan of kernels 5 and 6 (one for both): ``grid``
    co-resident blocks of 256 threads, each with ``smem_bytes`` of dynamic
    shared memory: a ring of ``FUSED_STEP_STAGES`` tiles of ``stage_bytes``,
    then the regions at the byte offsets ``regions`` (the staged matmul
    input, the column reduction, the column sums, the attention scratch);
    each projection's column groups (``projs``, ``chunk`` = K: one flat sum);
    and the attention chunks: at most ``max_chunks`` a head (a block each),
    each of at most ``chunk_rows`` rows."""

    grid: int
    stage_bytes: int
    max_chunks: int
    chunk_rows: int
    regions: dict
    smem_bytes: int
    projs: dict

    def ints(self, cfg, max_seq: int) -> list[int]:
        """The dims and the plan as the kernels' C entries take them."""
        sc = _layer_stack(cfg)
        dims = [sc.num_layers, sc.hidden_size, sc.num_heads, sc.num_kv_heads, sc.head_dim, sc.intermediate_size,
                max_seq]
        per = [v for name in FUSED_STEP_PROJS for v in (
            self.projs[name].nv, self.projs[name].groups, self.projs[name].tile_rows, self.projs[name].box_rows)]
        return dims + [self.grid, self.stage_bytes, self.max_chunks, *self.regions.values(), self.smem_bytes] + per


def fused_step_plan(cfg, dtype: torch.dtype = torch.bfloat16, sms: int = 132,
                    max_seq: int = CP_MAX_SEQ) -> FusedStepPlan:
    """The launch plan of kernels 5 and 6 for the int8 layer stack ``cfg``
    (a layer-stack config, or a config with ``layer_stack()``), activations
    in ``dtype``, caches of at most ``max_seq`` rows, on a card with ``sms``
    SMs.

    Each projection's columns go to as many blocks as the card has SMs, as
    in kernel 3 (``talker_step_plan``): a block owns ``nv`` vectors of 16
    int8 columns (of each half: gate|up's block owns the same columns of
    both), the fewest that leave at most ``sms`` groups and whose TMA box
    rows land 128-byte aligned, over the whole K. The grid is the most any
    projection uses (at least one block per q head); a head's rows <= pos
    are cut into one chunk per ``FUSED_STEP_CHUNK_ROWS`` rows, at most
    ``max_chunks`` = min(``FUSED_STEP_MAX_CHUNKS``, grid / heads), so that
    heads x chunks fit the grid. The staged input (the widest K), the column
    reduction and sums, and the attention scratch (the most rows a chunk
    holds below ``max_seq``) are fixed by the shapes; the ring takes what is
    left of an H100 block's 232,448 bytes. The weights are read as 4-D maps
    [L][K / box_rows][box_rows][N]: ``box_rows`` is the largest power of two
    of rows, at most 256, that divides K, lands 128-byte aligned and fits a
    tile; a tile is the most such row groups (at most 256) that fit and
    divide K, one TMA copy a half. Raises on shapes the kernels do not
    take, with the reason.
    """
    if dtype not in _DTYPES:
        raise ValueError(f"fused_step_plan: activations in {dtype}; the kernels take float32 or bfloat16")
    sc = _layer_stack(cfg)
    H, I, D, Hq, KV, L = (sc.hidden_size, sc.intermediate_size, sc.head_dim, sc.num_heads, sc.num_kv_heads,
                          sc.num_layers)
    qd, nqkv = Hq * D, (Hq + 2 * KV) * D
    t_vec = 4 if dtype == torch.float32 else 8
    if not (L >= 1 and min(H, I) >= 1 and max_seq >= 1):
        raise ValueError(f"fused_step_plan: no layers, widths or cache rows in {sc} with {max_seq} rows")
    if not (2 <= D <= FUSED_STEP_MAX_HEAD_DIM and D % 2 == 0 and D % t_vec == 0):
        raise ValueError(f"fused_step_plan: head_dim {D} is not an even multiple of {t_vec} up to "
                         f"{FUSED_STEP_MAX_HEAD_DIM} (16-byte cache row vectors of {dtype})")
    if not (KV >= 1 and Hq >= 1 and Hq % KV == 0 and Hq <= sms):
        raise ValueError(f"fused_step_plan: {Hq} q heads over {KV} kv heads: a whole multiple, at most one "
                         f"block per head on {sms} SMs")
    shapes = {"qkv": (H, nqkv, 1), "o": (qd, H, 1), "gate_up": (H, 2 * I, 2), "down": (I, H, 1)}
    chosen = {}
    for name, (k, n, halves) in shapes.items():
        if (n // halves) % _INT8_VEC:
            raise ValueError(f"fused_step_plan: {name} has {n // halves} columns, not a multiple of {_INT8_VEC}")
        nvec = n // halves // _INT8_VEC
        nv = -(-nvec // sms)
        while nv * halves <= CP_FRAME_THREADS and nv * _INT8_VEC <= CP_FRAME_BOX_COLUMNS and k % (8 // math.gcd(nv, 8)):
            nv += 1
        if nv * halves > CP_FRAME_THREADS or nv * _INT8_VEC > CP_FRAME_BOX_COLUMNS:
            raise ValueError(f"fused_step_plan: {name} ({k} x {n}) takes no column groups on {sms} SMs")
        chosen[name] = (k, n, halves, nv, -(-nvec // nv))
    grid = max([Hq] + [c[4] for c in chosen.values()])
    max_chunks = min(FUSED_STEP_MAX_CHUNKS, grid // Hq)
    chunk_rows = max(FUSED_STEP_CHUNK_ROWS, -(-max_seq // max_chunks))
    floats = {
        "xs": max(c[0] for c in chosen.values()),
        "red": max(_reduce_groups(c[3] * c[2]) * c[3] * c[2] * _INT8_VEC for c in chosen.values()),
        "cs": max(c[3] * c[2] * _INT8_VEC for c in chosen.values()),
        "misc": FUSED_STEP_MISC_FIXED + -(-chunk_rows // 32) * 32,
    }
    nbytes = {name: -(-4 * f // 128) * 128 for name, f in floats.items()}
    stage_bytes = (CP_FRAME_SMEM_LIMIT - sum(nbytes.values())) // FUSED_STEP_STAGES // 128 * 128
    regions, at = {}, FUSED_STEP_STAGES * stage_bytes
    for name, size in nbytes.items():
        regions[name], at = at, at + size
    projs = {}
    for name, (k, n, halves, nv, groups) in chosen.items():
        row_bytes = nv * halves * 16
        box = 256
        while box > 1 and (k % box or box * row_bytes > stage_bytes):
            box //= 2
        if stage_bytes < 128 or k % box or box * row_bytes > stage_bytes or box * nv * 16 % 128:
            raise ValueError(f"fused_step_plan: {name}'s K {k} takes no TMA box of 128-byte-aligned rows in a "
                             f"{max(stage_bytes, 0)}-byte ring tile (shared memory left by the staged input, "
                             f"{floats['xs']} floats, and {chunk_rows} attention rows)")
        tile_rows = min(k, stage_bytes // row_bytes // box * box, 256 * box)
        while k % tile_rows:
            tile_rows -= box
        projs[name] = TalkerProjPlan(k, n, halves, k, _INT8_VEC, nv, groups, tile_rows, box)
    return FusedStepPlan(grid, stage_bytes, max_chunks, chunk_rows, regions, at, projs)


def _raw_stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as a pointer (without a Stream object
    where the build offers that)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


class FusedStepPack:
    """What kernels 5 and 6 need of one fused int8 layer stack, checked and
    gathered once: the plan, the C entries' argument arrays, the weights'
    TMA descriptors, and a scratch that is zeroed once (its barrier count
    and counters carry over from call to call) and serves one call at a
    time.

    ``layers``: the canonical fused int8 tree ([L, K, N] int8 with [L, N]
    f32 scales; norms in ``dtype``), ``cfg`` its layer-stack config; caches
    of at most ``max_seq`` rows. Its owner keeps it beside the tree
    (``pipeline.Qwen3TTS`` builds one on the card when the code predictor
    takes the "layer_steps" route) and hands it, with a layer index, to
    every ``fused_attention_step`` and ``fused_mlp_step`` of that tree. The
    pack holds the tree's tensors, so the pointers in its descriptors stay
    valid while it lives. Its calls run on the stream of its first call; a
    call on another stream raises, since two calls must not share the
    scratch at once. A CUDA graph that captures calls replays on the pack's
    scratch, so calls outside the graph take a pack of their own.
    """

    def __init__(self, layers: dict, cfg, dtype: torch.dtype, dev: torch.device | str, max_seq: int = CP_MAX_SEQ):
        op = "fused_step"
        dev = torch.device(dev)
        if dev.type != "cuda" or dtype not in _DTYPES:
            raise ValueError(f"FusedStepPack: the kernels run on CUDA in float32 or bfloat16, not {dtype} on {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        sc = _layer_stack(cfg)
        leaves, quantized = _checked_stack(layers, sc, dtype, dev, op)
        if not quantized:
            raise ValueError(f"{op}: the kernel takes int8 weights only")
        self.plan = fused_step_plan(sc, dtype, min(quant._sm_count(dev), 132), max_seq)

        lib = _kernel_lib()
        ints = self.plan.ints(sc, max_seq)
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self.floats = (ctypes.c_float * 1)(sc.rms_norm_eps)
        self.scratch = torch.zeros(lib.q3_fused_step_scratch_floats(self.ints), dtype=torch.float32, device=dev)
        qkv_w, qkv_s, o_w, o_s, gu_w, gu_s, down_w, down_s, in_ln, post_ln, q_norm, k_norm = leaves
        ptrs = [qkv_w, o_w, gu_w, down_w, qkv_s, o_s, gu_s, down_s, in_ln, post_ln, q_norm, k_norm, self.scratch]
        self.ptrs = (ctypes.c_void_p * len(ptrs))(*[_ptr(t) for t in ptrs])
        self.maps = ctypes.create_string_buffer(lib.q3_fused_step_maps_bytes())
        err = lib.q3_fused_step_maps(self.ints, self.ptrs, self.maps)
        if err != 0:
            raise RuntimeError(f"{op}: the weights' TMA descriptors were refused: CUDA error {err}")
        if lib.q3_fused_step_call_slots() != len(FUSED_STEP_CALL_SLOTS):
            raise RuntimeError(f"{op}: the kernel library takes {lib.q3_fused_step_call_slots()} call slots, not "
                               f"{len(FUSED_STEP_CALL_SLOTS)}")
        self.call = (ctypes.c_int64 * len(FUSED_STEP_CALL_SLOTS))(
            _DTYPES[dtype], *(ctypes.addressof(a) for a in (self.ints, self.floats, self.ptrs, self.maps)))
        self.call_addr = ctypes.addressof(self.call)
        self.leaves = leaves  # the tensors the descriptors point into, kept alive with the pack
        self.dtype, self.dev, self.index = dtype, dev, dev.index
        self.layers, self.hidden, self.inter = sc.num_layers, sc.hidden_size, sc.intermediate_size
        self.attn_dims = (sc.num_heads, sc.num_kv_heads, sc.head_dim)
        self.kvd = sc.num_kv_heads * sc.head_dim
        self.eps = sc.rms_norm_eps
        self.max_seq = max_seq
        self.lib = lib
        self.stream = None  # the stream of the first call
        self.tables = (None, None, 0)  # the RoPE tables last checked, and their rows

    def check_tables(self, cos_t: torch.Tensor, sin_t: torch.Tensor, op: str) -> int:
        """The rows of the RoPE tables ``cos_t`` / ``sin_t``, checked once
        for each pair of tensors (a route passes the same pair every call)."""
        if cos_t is not self.tables[0] or sin_t is not self.tables[1]:
            half = self.attn_dims[2] // 2
            for name, t in (("cos_t", cos_t), ("sin_t", sin_t)):
                if (t.dtype != torch.float32 or t.get_device() != self.index or t.dim() != 2 or t.shape[1] != half
                        or not t.is_contiguous()):
                    raise ValueError(f"{op}: {name} must be a contiguous float32 [rows, {half}] table on {self.dev}")
            self.tables = (cos_t, sin_t, min(cos_t.shape[0], sin_t.shape[0]))
        return self.tables[2]

    @classmethod
    def of_layer(cls, layer: dict, dtype: torch.dtype, dev: torch.device, eps: float, max_seq: int, op: str):
        """The pack of one layer (``nn.layer_params_at``'s views, or any one
        fused int8 layer), as a stack of one, for a call given no pack; its
        dims are read from the weights."""
        try:
            D, H = layer["q_norm"].shape[-1], layer["input_ln"].shape[-1]
            qd, nqkv = layer["o_proj"]["q8"].shape[0], layer["qkv_proj"]["q8"].shape[-1]
            inter = layer["down_proj"]["q8"].shape[0]
            stacked = {name: layer[name] for name in (*_PROJS, "input_ln", "post_ln", "q_norm", "k_norm")}
        except (KeyError, TypeError, IndexError) as e:
            raise ValueError(f"{op}: the kernel takes one fused int8 layer (qkv_proj, o_proj, gateup_proj, "
                             f"down_proj, the four norms): {e!r}") from None
        if not all(quant.is_quantized(stacked[name]) for name in _PROJS):
            raise ValueError(f"{op}: the kernel takes int8 weights only")
        stacked = {name: {k: t.unsqueeze(0) for k, t in w.items()} if isinstance(w, dict) else w.unsqueeze(0)
                   for name, w in stacked.items()}
        stack = nn.LayerStackConfig(hidden_size=H, intermediate_size=inter, num_layers=1, num_heads=qd // D,
                                    num_kv_heads=(nqkv - qd) // (2 * D), head_dim=D, rms_norm_eps=eps)
        return cls(stacked, stack, dtype, dev, max_seq)


def _fused_call(pack, op: str, x: torch.Tensor, eps: float, layer_index: int, trace: bool) -> tuple:
    """The checks both kernels make with a pack (x, the layer, eps, the
    stream), then the output, the stream and the stamps (or None)."""
    if not isinstance(pack, FusedStepPack):
        raise ValueError(f"{op}: the pack is a {type(pack).__name__}, not a FusedStepPack")
    if x.dtype != pack.dtype or x.get_device() != pack.index or x.numel() != pack.hidden or not x.is_contiguous():
        raise ValueError(f"{op}: x must be a contiguous {pack.dtype} tensor of {pack.hidden} values on {pack.dev}; "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 0 <= layer_index < pack.layers or eps != pack.eps:
        raise ValueError(f"{op}: layer {layer_index} with eps {eps}; the pack holds {pack.layers} layers, eps "
                         f"{pack.eps}")
    stream = _raw_stream(pack.dev)
    if pack.stream is None:
        pack.stream = stream
    elif stream != pack.stream:
        raise RuntimeError(f"{op}: the pack's calls run on stream {pack.stream:#x}, not {stream:#x}; "
                           "give each stream a pack of its own")
    stamps = None
    if trace:
        stamps = torch.zeros((pack.plan.grid, pack.lib.q3_fused_step_trace_slots()), dtype=torch.int64,
                             device=pack.dev)
    return torch.empty_like(x), stream, stamps


def fused_attention_step(
    x, layer, cos_t, sin_t, ck, cv, pos: int, heads: int, kv_heads: int, head_dim: int, eps: float,
    residual: bool = True, pack: FusedStepPack | None = None, layer_index: int = 0, trace: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5: the CUDA kernel (``csrc/fused_step.cu``, one persistent
    launch) on a CUDA tensor, the plain version on a CPU tensor (arguments
    and result as ``fused_attention_step_plain``); with ``trace`` (the card
    only) also the kernel's int64 [grid, slots] phase stamps in ns
    (``fused_step_trace_phases`` reads them).

    ``pack``: the layer stack's ``FusedStepPack``, which spares each call
    the checks and the set-up; the call then runs layer ``layer_index`` of
    the pack's stack (``layer`` is not read) and checks only x, the caches,
    pos and the stream. Without one, the call builds a pack of ``layer``
    for itself."""
    op = "fused_attention_step"
    if not _on_card(x, op):
        return fused_attention_step_plain(x, layer, cos_t, sin_t, ck, cv, pos, heads, kv_heads, head_dim, eps, residual)
    S = ck.shape[0] if ck.dim() == 2 else 0
    if pack is None:
        pack, layer_index = FusedStepPack.of_layer(layer, x.dtype, x.device, eps, S, op), 0
    y, stream, stamps = _fused_call(pack, op, x, eps, layer_index, trace)
    if (heads, kv_heads, head_dim) != pack.attn_dims:
        raise ValueError(f"{op}: {heads} / {kv_heads} heads of {head_dim}; the pack's are {pack.attn_dims}")
    caches = []
    for name, c in (("cache k", ck), ("cache v", cv)):
        ptr = c.data_ptr()
        if (c.dtype != pack.dtype or c.get_device() != pack.index or c.shape != (S, pack.kvd) or ptr % 16
                or not c.is_contiguous()):
            raise ValueError(f"{op}: {name} must be a contiguous, 16-byte aligned {pack.dtype} tensor of shape "
                             f"({S}, {pack.kvd}) on {pack.dev}; got {c.dtype} {tuple(c.shape)} on {c.device}")
        caches.append(ptr)
    if not 0 <= pos < S or pos >= pack.check_tables(cos_t, sin_t, op) or S > pack.max_seq:
        raise ValueError(f"{op}: pos {pos} outside the {S}-row cache or the RoPE tables, or a cache wider than the "
                         f"pack's {pack.max_seq} rows")
    pack.call[_CALL_FIRST:] = (0, layer_index, x.data_ptr(), y.data_ptr(), *caches, cos_t.data_ptr(), sin_t.data_ptr(),
                               S, pos, int(residual), stamps.data_ptr() if trace else 0, stream)
    err = pack.lib.q3_fused_step_call(pack.call_addr)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    fused_attention_step.launches += 1
    return (y, stamps) if trace else y


fused_attention_step.launches = 0  # kernel launches (CPU-plain calls are not counted)


def fused_mlp_step(
    x, layer, intermediate: int, eps: float, residual: bool = True, pack: FusedStepPack | None = None,
    layer_index: int = 0, trace: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6: the CUDA kernel (``csrc/fused_step.cu``, one persistent
    launch) on a CUDA tensor, the plain version on a CPU tensor (as
    ``fused_mlp_step_plain``); ``pack``, ``layer_index`` and ``trace`` as
    ``fused_attention_step``'s."""
    op = "fused_mlp_step"
    if not _on_card(x, op):
        return fused_mlp_step_plain(x, layer, intermediate, eps, residual)
    if pack is None:
        pack, layer_index = FusedStepPack.of_layer(layer, x.dtype, x.device, eps, 1, op), 0
    y, stream, stamps = _fused_call(pack, op, x, eps, layer_index, trace)
    if intermediate != pack.inter:
        raise ValueError(f"{op}: intermediate {intermediate}; the pack's is {pack.inter}")
    pack.call[_CALL_FIRST:] = (1, layer_index, x.data_ptr(), y.data_ptr(), 0, 0, 0, 0, 0, 0, int(residual),
                               stamps.data_ptr() if trace else 0, stream)
    err = pack.lib.q3_fused_step_call(pack.call_addr)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    fused_mlp_step.launches += 1
    return (y, stamps) if trace else y


fused_mlp_step.launches = 0  # kernel launches (CPU-plain calls are not counted)


def fused_step_trace_phases(stamps: torch.Tensor, sublayer: str) -> dict:
    """Where a traced call of kernel 5 (``sublayer`` "attention") or 6
    ("mlp") went, from its stamps, in µs by phase (attention: qkv, scores,
    values, o; mlp: gate_up, down; see ``_phase_sums``: ``tiles`` is a
    GEMV's tile loop, or the attention itself), with each phase's
    ``epilogue``: its work after staging and the longest work."""
    kinds = FUSED_STEP_PHASES[sublayer]
    out = _phase_sums(stamps[:, : 4 * len(kinds)], list(kinds))
    for kind in kinds:
        k = out[kind]
        k["epilogue"] = k["work"] - k["stage"] - k["tiles"]
    return out


def streamed_decode_step(
    layers: dict, x, cfg, ck, cv, pos: int, cos_t, sin_t, pack: CpStepPack | None = None, trace: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: the CUDA kernel on a CUDA tensor (one persistent launch,
    ``csrc/talker_step.cu`` in its normalised form), the plain version on a
    CPU tensor (arguments and result as ``streamed_decode_step_plain``);
    with ``trace`` (the card only) also the kernel's phase stamps
    (``talker_step_trace_phases`` reads them). The kernel takes the
    canonical fused int8 tree, norms and caches in x's dtype, caches of at
    most 256 rows (one attention chunk). ``pack``: the tree's
    ``CpStepPack``; without one, the call builds a pack for itself (for this
    cache's rows)."""
    op = "streamed_decode_step"
    if not _on_card(x, op):
        return streamed_decode_step_plain(layers, x, cfg, ck, cv, pos, cos_t, sin_t)
    dev, dt = x.device, x.dtype
    sc = _layer_stack(cfg)
    D = sc.head_dim
    for name, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        _check(t, name, (t.shape[0], D // 2), torch.float32, dev, op)
    if not 0 <= pos < min(cos_t.shape[0], sin_t.shape[0]):
        raise ValueError(f"{op}: pos {pos} outside the RoPE tables")
    if pack is None:
        pack = CpStepPack(layers, sc, dt, dev, max_seq=ck.shape[1] if ck.dim() == 3 else 0)
    elif not isinstance(pack, CpStepPack) or not pack.holds(layers, sc, dt, dev):
        raise ValueError(f"{op}: the pack was built for another tree, config, dtype or device, or for kernel 3")
    out = _launch_step(pack, op, x, sc, ck, cv, pos, trace, (cos_t, sin_t))
    streamed_decode_step.launches += 1
    return out


streamed_decode_step.launches = 0  # steps the kernel ran (CPU-plain calls are not counted)


def run_fused_decode_step(
    layers: dict, x, cfg, ck, cv, pos: int, cos_t, sin_t, streamed: bool, layer_views: list | None = None,
    step_pack: CpStepPack | FusedStepPack | None = None,
) -> torch.Tensor:
    """One decode step over all layers with the fused int8 kernels (the JAX
    ``run_fused_decode_step``; its stream pack becomes ``streamed``).

    ``streamed=True``: the whole step is kernel 7 on the stacked ``layers``
    (through ``step_pack``, the tree's ``CpStepPack`` on the card; built per
    call when None); False: kernels 5 + 6 per layer (through ``step_pack``,
    the tree's ``FusedStepPack`` on the card, with each layer's index; each
    call packs its layer for itself when None), on ``layer_views`` (the
    per-layer views ``nn.layer_params_at`` gives, which a caller looping
    over steps takes once; taken here when None). x: [1, 1, H]; ck, cv: [L,
    S, KV*D] planes, row ``pos`` written in place; cos_t/sin_t: [>= pos+1,
    D/2] f32. Returns [1, 1, H].
    """
    if streamed:
        return streamed_decode_step(layers, x, cfg, ck, cv, pos, cos_t, sin_t, step_pack)
    if layer_views is None:
        layer_views = [nn.layer_params_at(layers, l) for l in range(ck.shape[0])]
    h = x.reshape(1, cfg.hidden_size)
    for l, layer in enumerate(layer_views):
        h = fused_attention_step(
            h, layer, cos_t, sin_t, ck[l], cv[l], pos, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.rms_norm_eps, pack=step_pack, layer_index=l,
        )
        h = fused_mlp_step(h, layer, cfg.intermediate_size, cfg.rms_norm_eps, pack=step_pack, layer_index=l)
    return h.reshape(1, 1, cfg.hidden_size)


# ---------------------------------------------------------------------------
# Tensor-parallel decode step: kernels 5 and 6 on every rank (residual=False)
# with an all-reduce between the sub-layers, Megatron style (the JAX
# package's shard_map around its sub-layer kernels). The whole-step kernel
# cannot be used here: its residual chain would need a collective between
# sub-layers of one launch.
#
# A fused [q|k|v] / [gate|up] is not head-aligned under plain column chunks
# (chunk i of the concatenation is not (q_i|k_i|v_i)), so Qwen3TTS.shard
# builds a column-permuted copy (make_tp_pack) whose contiguous chunk i is
# exactly rank i's (q_i|k_i|v_i) / (gate_i|up_i). The o / down row chunks are
# head- and intermediate-aligned as they are.
# ---------------------------------------------------------------------------


def _tp_block_perm(widths: tuple[int, ...], tp: int) -> np.ndarray:
    """Column permutation making each rank's slice of every block contiguous:
    new columns = concat over ranks i of [block_0's i-th 1/tp, block_1's, ...]."""
    offs = np.cumsum([0] + list(widths))
    idx = []
    for i in range(tp):
        for b, w in enumerate(widths):
            wl = w // tp
            start = offs[b] + i * wl
            idx.extend(range(start, start + wl))
    return np.asarray(idx, np.int64)


def make_tp_pack(stacked_layers: dict, cfg, tp: int) -> dict | None:
    """Head- / intermediate-aligned column re-layouts of qkv and gate|up for
    tp ranks: ``{"qkv": {"q8" [L, H, Nq], "scale" [L, Nq]}, "gu": {...}}``
    (split by ``parallel.sharding.tp_pack_specs``), the JAX package's bit for
    bit; None where the JAX package's is: the tree is not fused int8, or tp
    does not divide the heads, the KV heads or the intermediate."""
    if not supports_fused_step(stacked_layers):
        return None
    sc = _layer_stack(cfg)
    if sc.num_heads % tp or sc.num_kv_heads % tp or sc.intermediate_size % tp:
        return None
    q_dim, kv_dim = sc.num_heads * sc.head_dim, sc.num_kv_heads * sc.head_dim

    def permute(proj: dict, widths: tuple) -> dict:
        perm = torch.from_numpy(_tp_block_perm(widths, tp)).to(proj["q8"].device)
        return {"q8": proj["q8"][:, :, perm], "scale": proj["scale"][:, perm].float()}

    return {
        "qkv": permute(stacked_layers["qkv_proj"], (q_dim, kv_dim, kv_dim)),
        "gu": permute(stacked_layers["gateup_proj"], (sc.intermediate_size, sc.intermediate_size)),
    }


def tp_step_packs(rank_layers: list[dict], tp_pack: list[dict], cfg, dtype: torch.dtype,
                  devices: list[torch.device]) -> list[FusedStepPack]:
    """Each rank's ``FusedStepPack`` on its card, built once (``Qwen3TTS.shard``):
    rank t's tp-pack columns of qkv and gate|up, its o and down rows and the
    norms, on a rank-local config, for caches of up to
    ``TALKER_STREAM_MAX_SEQ`` rows (every generation tier, so a cache that
    grows keeps its packs). Ranks that share a card each get their own (a
    pack's scratch serves one call at a time)."""
    sc = nn.tp_local_config(_layer_stack(cfg), len(devices))
    packs = []
    for layers, pack, dev in zip(rank_layers, tp_pack, devices):
        with collectives.device_scope(dev):
            packs.append(FusedStepPack(dict(layers, qkv_proj=pack["qkv"], gateup_proj=pack["gu"]), sc, dtype, dev,
                                       TALKER_STREAM_MAX_SEQ))
    return packs


def tp_decode_step(
    rank_layers: list[dict],
    tp_pack: list[dict],
    x: torch.Tensor,
    cfg,
    cache_k: list[torch.Tensor],
    cache_v: list[torch.Tensor],
    pos: int,
    devices: list[torch.device],
    packs: list[FusedStepPack] | None = None,
) -> torch.Tensor:
    """One tensor-parallel decode step through every layer, kernels 5 and 6
    on every rank (the JAX ``tp_decode_step``).

    ``rank_layers[t]`` / ``tp_pack[t]``: rank t's slice of the canonical
    fused int8 tree (its o and down rows, the norms) and its chunk of the
    tp pack (``make_tp_pack``), on ``devices[t]``; ``cache_k[t]`` /
    ``cache_v[t]``: its KV heads' planes [L, S, KV/tp * D], row ``pos``
    written in place. x [1, 1, H] lies on the first device; every rank gets
    it (``collectives.broadcast``). For each layer and rank: kernel 5
    (``residual=False``) on the rank's qkv columns, o rows and cache plane,
    then the all-reduce and the residual add; kernel 6 likewise. ``packs``:
    the ranks' ``tp_step_packs`` on the cards (each rank's calls launched on
    its device, on the stream of its pack's first call); without them, a
    call on a card packs its layer for itself, and on the CPU the plain
    versions run. RoPE tables of ``TALKER_STREAM_MAX_SEQ`` rows, one pair a
    device. Returns [1, 1, H] on the first device.
    """
    tp = len(devices)
    sc = nn.tp_local_config(_layer_stack(cfg), tp)
    heads, kv, d, inter, eps = sc.num_heads, sc.num_kv_heads, sc.head_dim, sc.intermediate_size, sc.rms_norm_eps
    h_size = sc.hidden_size
    tables = [rope_tables(d, sc.rope_theta, TALKER_STREAM_MAX_SEQ, dev) for dev in devices]
    packs = packs or [None] * tp
    # With packs the kernels read the packs' weights, not the layer views.
    trees = [None if p else dict(lyr, qkv_proj=tpk["qkv"], gateup_proj=tpk["gu"])
             for p, lyr, tpk in zip(packs, rank_layers, tp_pack)]
    hs = collectives.broadcast(x.reshape(1, h_size), devices)
    for i in range(sc.num_layers):
        views = [None if tree is None else nn.layer_params_at(tree, i) for tree in trees]
        parts = []
        for t, dev in enumerate(devices):
            with collectives.device_scope(dev):
                parts.append(fused_attention_step(hs[t], views[t], *tables[t], cache_k[t][i], cache_v[t][i], pos,
                                                  heads, kv, d, eps, residual=False, pack=packs[t], layer_index=i))
        hs = nn.add_per_rank(hs, collectives.all_reduce(parts))
        parts = []
        for t, dev in enumerate(devices):
            with collectives.device_scope(dev):
                parts.append(fused_mlp_step(hs[t], views[t], inter, eps, residual=False, pack=packs[t],
                                            layer_index=i))
        hs = nn.add_per_rank(hs, collectives.all_reduce(parts))
    return hs[0].reshape(1, 1, h_size)
