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
both forms of ``streamed_talker_step``); its plain version is
``talker_step_plain``.

The per-step int8 code predictor, for trees the frame kernel does not take
(``supports_cp_frame_kernel``): ``fused_attention_step`` and
``fused_mlp_step`` (``csrc/fused_step.cu``, the ports of the JAX package's
functions of those names; ``residual=False`` gives the tensor-parallel
partials) and ``streamed_decode_step`` (``csrc/cp_step.cu``, the port of
``streamed_decode_step``, reading the canonical int8 tree instead of the
stream pack), chosen per step by ``run_fused_decode_step``.

Every wrapper runs its plain version on CPU tensors, launches its kernel on
CUDA tensors (or raises), and raises on any other device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

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
    stack_cfg = cfg.layer_stack()
    dev = talker_hidden.device
    cache = nn.init_kv_cache(stack_cfg, 1, CP_MAX_SEQ, talker_hidden.dtype, dev)
    heads = params["lm_heads"]

    x = mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    h = nn.run_layer_stack(
        params["layers"], x, stack_cfg, cache, torch.arange(2, device=dev), 0, self_attn_prefill=True, matmul=matmul
    )
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    code = torch.argmax(matmul(h[:, 1], head(heads, 0)), dim=-1)  # [1]
    codes = [code]
    for g in range(1, cfg.num_acoustic):
        pos = g + 1
        x = mtp_project(params, params["codec_embeddings"][g - 1][code][None])
        h = nn.run_layer_stack(
            params["layers"], x, stack_cfg, cache, torch.full((1,), pos, device=dev), pos, matmul=matmul
        )
        h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
        code = torch.argmax(matmul(h[:, 0], head(heads, g)), dim=-1)
        codes.append(code)
    return torch.cat(codes).to(torch.int32)


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
        lib.q3_talker_step_scratch_floats.argtypes = [i32] * 9
        lib.q3_talker_step.restype = i32
        lib.q3_talker_step.argtypes = [i32, i32] + [ptr] * 17 + [i32] * 8 + [ctypes.c_float, ptr, ptr, ptr]
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


def cp_frame_trace_phases(stamps: torch.Tensor, cfg) -> dict:
    """Where a traced frame's time went, from ``cp_frame(..., trace=True)``'s
    stamps, in µs summed over the frame's phases (each phase: the blocks
    between two barriers): ``span`` the frame from the first block's first
    stamp to the last leave; per phase kind (mtp, qkv, attention, o, gate_up,
    down, head), ``work`` from the phase's start (the previous barrier's
    last leave) to its last arrival, of which ``stage`` to the last block's
    GEMV start and ``tiles`` the longest GEMV, and ``barrier`` from the last
    arrival to the last leave."""
    st = stamps.cpu().double().reshape(stamps.shape[0], -1, 4) / 1e3  # [blocks, phases, 4] in µs
    layers = cfg.layer_stack().num_layers
    kinds = (["mtp"] if cfg.needs_projection else []) + ["qkv", "attention", "o", "gate_up", "down"] * layers + ["head"]
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


def talker_step(layers: dict, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int) -> torch.Tensor:
    """One talker decode step: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor (arguments and result as ``talker_step_plain``).

    The kernel takes the canonical fused tree with all four projections
    int8 (``[L, K, N]`` int8 with ``[L, N]`` f32 scales) or all plain in x's
    dtype (``[L, K, N]``); norms and caches in x's dtype. A mixed tree
    raises.
    """
    dev = x.device
    if dev.type == "cpu":
        return talker_step_plain(layers, x, cfg, ck, cv, pos)
    if dev.type != "cuda":
        raise ValueError(f"talker_step: no kernel for device {dev}")
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"talker_step: unsupported dtype {dtype}")
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    qd, kvd = hq * D, kv * D
    L, S = ck.shape[0], ck.shape[1]
    shapes = {"qkv_proj": (L, H, qd + 2 * kvd), "o_proj": (L, qd, H), "gateup_proj": (L, H, 2 * I), "down_proj": (L, I, H)}
    quantized = _check_linears({n: (layers[n], shape) for n, shape in shapes.items()}, dtype, dev, "talker_step")
    for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
        _check(layers[name], name, shape, dtype, dev, "talker_step")
    _check(ck, "cache k", (L, S, kvd), dtype, dev, "talker_step")
    _check(cv, "cache v", (L, S, kvd), dtype, dev, "talker_step")
    if not 0 <= pos < S:
        raise ValueError(f"talker_step: pos {pos} outside the {S}-row cache")
    xin = x.reshape(H).contiguous()
    _check(xin, "x", (H,), dtype, dev, "talker_step")

    lib = _kernel_lib()
    n_scratch = lib.q3_talker_step_scratch_floats(_DTYPES[dtype], int(quantized), L, H, hq, kv, D, I, S)
    if n_scratch == 0:
        raise ValueError(f"talker_step: the kernel does not take these shapes ({cfg}, S={S}, int8={quantized})")
    cos_t, sin_t = rope_tables(D, cfg.rope_theta, S, dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    y = torch.empty(H, dtype=dtype, device=dev)
    weights = [
        p for name in _PROJS
        for p in ((layers[name]["q8"].data_ptr(), layers[name]["scale"].data_ptr()) if quantized
                  else (layers[name].data_ptr(), None))
    ]
    err = lib.q3_talker_step(
        _DTYPES[dtype], int(quantized), xin.data_ptr(), *weights,
        layers["input_ln"].data_ptr(), layers["post_ln"].data_ptr(),
        layers["q_norm"].data_ptr(), layers["k_norm"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        L, H, hq, kv, D, I, S, pos, cfg.rms_norm_eps,
        scratch.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"talker_step kernel launch failed: CUDA error {err}")
    talker_step.launches += 1
    return y.reshape(1, 1, H)


talker_step.launches = 0  # steps the kernel ran, either form (CPU-plain calls are not counted)


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


def _step_lib():
    lib = _kernel_lib()
    if not getattr(lib, "_q3_step_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_decode_layer_scratch_floats.restype = ctypes.c_size_t
        lib.q3_decode_layer_scratch_floats.argtypes = [i32] * 7
        lib.q3_attention_step.restype = i32
        lib.q3_attention_step.argtypes = [i32] + [ptr] * 13 + [i32] * 6 + [ctypes.c_float, i32, ptr, ptr]
        lib.q3_mlp_step.restype = i32
        lib.q3_mlp_step.argtypes = [i32] + [ptr] * 6 + [i32, i32, ctypes.c_float, i32, ptr, ptr, ptr]
        lib.q3_cp_step.restype = i32
        lib.q3_cp_step.argtypes = [i32] + [ptr] * 17 + [i32] * 8 + [ctypes.c_float, ptr, ptr, ptr]
        lib._q3_step_bound = True
    return lib


def _on_card(x: torch.Tensor, op: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA tensor
    of a dtype the kernels take; raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{op}: unsupported dtype {x.dtype}")
    return True


def _scratch(lib, x, heads, kv_heads, D, inter, S, op) -> torch.Tensor:
    """f32 scratch of the decode-layer kernels for x's dtype and width;
    ``heads`` 0: the MLP only, ``inter`` 0: the attention only."""
    H = x.shape[-1]
    n = lib.q3_decode_layer_scratch_floats(_DTYPES[x.dtype], H, heads, kv_heads, D, inter, S)
    if n == 0:
        raise ValueError(f"{op}: the kernel does not take these shapes (H={H}, heads={heads}/{kv_heads}, "
                         f"head_dim={D}, intermediate={inter}, S={S})")
    return torch.empty(n, dtype=torch.float32, device=x.device)


def fused_attention_step(
    x, layer, cos_t, sin_t, ck, cv, pos: int, heads: int, kv_heads: int, head_dim: int, eps: float,
    residual: bool = True,
) -> torch.Tensor:
    """Kernel 5: the CUDA kernel (``csrc/fused_step.cu``) on a CUDA tensor,
    the plain version on a CPU tensor (arguments and result as
    ``fused_attention_step_plain``)."""
    op = "fused_attention_step"
    if not _on_card(x, op):
        return fused_attention_step_plain(x, layer, cos_t, sin_t, ck, cv, pos, heads, kv_heads, head_dim, eps, residual)
    dev, dt = x.device, x.dtype
    H, D = x.shape[-1], head_dim
    qd, kvd = heads * D, kv_heads * D
    S = ck.shape[0]
    _check(x, "x", (1, H), dt, dev, op)
    for name, shape in {"qkv_proj": (H, qd + 2 * kvd), "o_proj": (qd, H)}.items():
        if not _check_linear(layer[name], name, shape, dt, dev, op):
            raise ValueError(f"{op}: the kernel takes int8 weights only ({name} is plain)")
    for name, shape in {"input_ln": (H,), "q_norm": (D,), "k_norm": (D,)}.items():
        _check(layer[name], name, shape, dt, dev, op)
    _check(ck, "cache k", (S, kvd), dt, dev, op)
    _check(cv, "cache v", (S, kvd), dt, dev, op)
    for name, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        _check(t, name, (t.shape[0], D // 2), torch.float32, dev, op)
    if not 0 <= pos < min(S, cos_t.shape[0], sin_t.shape[0]):
        raise ValueError(f"{op}: pos {pos} outside the {S}-row cache or the RoPE tables")
    lib = _step_lib()
    scratch = _scratch(lib, x, heads, kv_heads, D, 0, S, op)
    y = torch.empty_like(x)
    err = lib.q3_attention_step(
        _DTYPES[dt], x.data_ptr(), layer["input_ln"].data_ptr(),
        layer["qkv_proj"]["q8"].data_ptr(), layer["qkv_proj"]["scale"].data_ptr(),
        layer["q_norm"].data_ptr(), layer["k_norm"].data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        layer["o_proj"]["q8"].data_ptr(), layer["o_proj"]["scale"].data_ptr(), ck.data_ptr(), cv.data_ptr(),
        y.data_ptr(), H, heads, kv_heads, D, S, pos, eps, int(residual), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    fused_attention_step.launches += 1
    return y


fused_attention_step.launches = 0  # kernel launches (CPU-plain calls are not counted)


def fused_mlp_step(x, layer, intermediate: int, eps: float, residual: bool = True) -> torch.Tensor:
    """Kernel 6: the CUDA kernel (``csrc/fused_step.cu``) on a CUDA tensor,
    the plain version on a CPU tensor (as ``fused_mlp_step_plain``)."""
    op = "fused_mlp_step"
    if not _on_card(x, op):
        return fused_mlp_step_plain(x, layer, intermediate, eps, residual)
    dev, dt = x.device, x.dtype
    H, I = x.shape[-1], intermediate
    _check(x, "x", (1, H), dt, dev, op)
    for name, shape in {"gateup_proj": (H, 2 * I), "down_proj": (I, H)}.items():
        if not _check_linear(layer[name], name, shape, dt, dev, op):
            raise ValueError(f"{op}: the kernel takes int8 weights only ({name} is plain)")
    _check(layer["post_ln"], "post_ln", (H,), dt, dev, op)
    lib = _step_lib()
    scratch = _scratch(lib, x, 0, 0, 0, I, 0, op)
    y = torch.empty_like(x)
    err = lib.q3_mlp_step(
        _DTYPES[dt], x.data_ptr(), layer["post_ln"].data_ptr(),
        layer["gateup_proj"]["q8"].data_ptr(), layer["gateup_proj"]["scale"].data_ptr(),
        layer["down_proj"]["q8"].data_ptr(), layer["down_proj"]["scale"].data_ptr(),
        H, I, eps, int(residual), scratch.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    fused_mlp_step.launches += 1
    return y


fused_mlp_step.launches = 0  # kernel launches (CPU-plain calls are not counted)


def streamed_decode_step(layers: dict, x, cfg, ck, cv, pos: int, cos_t, sin_t) -> torch.Tensor:
    """Kernel 7: the CUDA kernel (``csrc/cp_step.cu``) on a CUDA tensor, the
    plain version on a CPU tensor (as ``streamed_decode_step_plain``). The
    kernel takes the canonical fused int8 tree, norms and caches in x's
    dtype."""
    op = "streamed_decode_step"
    if not _on_card(x, op):
        return streamed_decode_step_plain(layers, x, cfg, ck, cv, pos, cos_t, sin_t)
    dev, dt = x.device, x.dtype
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    qd, kvd = hq * D, kv * D
    L, S = ck.shape[0], ck.shape[1]
    linears = {"qkv_proj": (L, H, qd + 2 * kvd), "o_proj": (L, qd, H), "gateup_proj": (L, H, 2 * I), "down_proj": (L, I, H)}
    for name, shape in linears.items():
        if not _check_linear(layers[name], name, shape, dt, dev, op):
            raise ValueError(f"{op}: the kernel takes int8 weights only ({name} is plain)")
    for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
        _check(layers[name], name, shape, dt, dev, op)
    _check(ck, "cache k", (L, S, kvd), dt, dev, op)
    _check(cv, "cache v", (L, S, kvd), dt, dev, op)
    for name, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        _check(t, name, (t.shape[0], D // 2), torch.float32, dev, op)
    if not 0 <= pos < min(S, cos_t.shape[0], sin_t.shape[0]):
        raise ValueError(f"{op}: pos {pos} outside the {S}-row cache or the RoPE tables")
    xin = x.reshape(H).contiguous()
    lib = _step_lib()
    scratch = _scratch(lib, xin, hq, kv, D, I, S, op)
    y = torch.empty(H, dtype=dt, device=dev)
    err = lib.q3_cp_step(
        _DTYPES[dt], xin.data_ptr(),
        *[t.data_ptr() for name in _PROJS for t in (layers[name]["q8"], layers[name]["scale"])],
        layers["input_ln"].data_ptr(), layers["post_ln"].data_ptr(),
        layers["q_norm"].data_ptr(), layers["k_norm"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        L, H, hq, kv, D, I, S, pos, cfg.rms_norm_eps,
        scratch.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    streamed_decode_step.launches += 1
    return y.reshape(1, 1, H)


streamed_decode_step.launches = 0  # steps the kernel ran (CPU-plain calls are not counted)


def run_fused_decode_step(
    layers: dict, x, cfg, ck, cv, pos: int, cos_t, sin_t, streamed: bool, layer_views: list | None = None
) -> torch.Tensor:
    """One decode step over all layers with the fused int8 kernels (the JAX
    ``run_fused_decode_step``; its stream pack becomes ``streamed``).

    ``streamed=True``: the whole step is kernel 7 on the stacked ``layers``;
    False: kernels 5 + 6 per layer, on ``layer_views`` (the per-layer views
    ``nn.layer_params_at`` gives, which a caller looping over steps takes
    once; taken here when None). x: [1, 1, H]; ck, cv: [L, S, KV*D] planes,
    row ``pos`` written in place; cos_t/sin_t: [>= pos+1, D/2] f32. Returns
    [1, 1, H].
    """
    if streamed:
        return streamed_decode_step(layers, x, cfg, ck, cv, pos, cos_t, sin_t)
    if layer_views is None:
        layer_views = [nn.layer_params_at(layers, l) for l in range(ck.shape[0])]
    h = x.reshape(1, cfg.hidden_size)
    for l, layer in enumerate(layer_views):
        h = fused_attention_step(
            h, layer, cos_t, sin_t, ck[l], cv[l], pos, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_norm_eps
        )
        h = fused_mlp_step(h, layer, cfg.intermediate_size, cfg.rms_norm_eps)
    return h.reshape(1, 1, cfg.hidden_size)
