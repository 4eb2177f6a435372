"""Flash attention backward (the gradient of the LM stack's attention in
training).

Replaces no Pallas kernel of its own: the reference differentiates its
jnp chunked attention (``src/repro/models/attention.py:86``) with JAX's
autodiff, and on the card the port's forward is the hand-written kernel
of :mod:`repro_torch.kernels.flash_attn`, so its gradient is a kernel too.
The CUDA kernels (``csrc/flash_attn_bwd.cu``) take q (B, H, S, D), k
(B, Hk, T, D) and v (B, Hk, T, Dv) with ``H`` a multiple of ``Hk``, the
forward's output and its gradient dO (B, H, S, Dv), and the forward's row
log-sum-exp (B, H, S) float32, and write dq, dk (width D) and dv (width
Dv) in the operands' dtype, float32 or bfloat16: a pre-pass that writes
each query row's record ``{lse * log2 e, delta = rowsum(dO * O)}`` (over
Dv; :func:`row_records_plain`), then one kernel that
recomputes the softmax from the records and accumulates dK and dV of a key
tile over every query tile and every query head of its group, and one
that does the same for dQ of a query tile; no atomics, so two runs give
the same bits.  bfloat16 at (64, 64), (128, 128) and multi-head latent
attention's (192, 128) (:data:`WGMMA_DIMS`) runs on ``wgmma`` fed by
TMA, on grids that :func:`bwd_plan` orders longest walk first, so that
the causal triangle's short key tiles fill in behind its long ones (at
(192, 128) in groups of :data:`HEAD_GROUP` KV heads, whose operands stay
in L2 while their blocks walk them); bfloat16 at D 16, 32, 80 and 192
runs on ``mma.sync`` m16n8k16, float32 at every pair and bfloat16 at D 8
and 40 and at (24, 16) on register FMAs (no TF32).  It takes every pair
of ``flash_attn.PAIRS`` (the (D, D) of ``flash_attn.HEAD_DIMS``,
DeepSeek-V3's (192, 128) and its smoke config's (24, 16)) at the
caller's scale, causal or full, and the forward's sliding window (the
hybrid family's): every kernel masks by the forward's rule (query s sees
key t only when s - t < window), a key tile walks only the query tiles
its window reaches and a query tile only the key tiles from its first
row's first visible key (:func:`key_walk`, :func:`query_walk`); another
pair raises ``ValueError`` before any launch.  Bound at Qwen3-4B's,
DeepSeek-V3's and Hymba-1.5B's training shapes: tensor-core operations
(the source's header).  Every operand and output may be a strided view
whose feature axis is contiguous (``flash_attn.layout_error``).

The plain version, :func:`flash_attention_bwd_plain`, is autograd through
``ref.flash_attention`` in float32, cast to the operands' dtype: the path
for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref
from .flash_attn import PAIRS, layout_error

# Calls of flash_attention_bwd that launched the kernels (the pre-pass,
# dK/dV and dQ: one count); the plain path never counts.
LAUNCHES = 0

# q, k, v, out, dout, lse, rows, dq, dk, dv, their 24 strides, B, H, Hk,
# S, T, D, Dv, scale, causal, window, (bf16: the plan's keys a dK/dV block,
# head group, dK/dV grid, and its key-tile and query-tile orders with their
# lengths,) stream.
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
         + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
_ORDER = [ctypes.POINTER(ctypes.c_ushort), ctypes.c_int]
_SIGNATURES = {
    "flash_attn_bwd_f32": _ARGS + [ctypes.c_void_p],
    "flash_attn_bwd_bf16": _ARGS + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong] + _ORDER * 2
    + [ctypes.c_void_p],
    "flash_attn_bwd_wgmma_smem": [ctypes.c_int] * 3}
_ENTRY = {torch.float32: "flash_attn_bwd_f32",
          torch.bfloat16: "flash_attn_bwd_bf16"}


# bfloat16 (D, Dv) pairs on the wgmma kernels; the others keep the
# mma.sync and FMA kernels (at (192, 192) dK and dV do not fit a thread's
# registers beside the scores).  At (D, D) a dK/dV block takes 64 keys that
# its two consumers share; at multi-head latent attention's (192, 128) it
# takes 128, 64 a consumer, whose dK (96 floats a thread) and dV (64) fit
# beside one score tile (P^T and dS^T go through shared memory).
WGMMA_DIMS = ((64, 64), (128, 128), (192, 128))
TILE = 64           # the wgmma kernels' keys and queries a tile
DQ_ROWS = 128       # query rows of a dQ block: two consumers of 64
# At (192, 128) blocks launch in groups of this many KV heads (all of a
# group's blocks before the next group's), so that the operands the
# blocks in flight stream (Q and dO for dK/dV, K and V for dQ: 1.31 MB a
# head at DeepSeek-V3's 2048 rows) stay in the 50 MB L2 while they walk
# them; at (D, D) every head is in flight at once, as before.
HEAD_GROUP = 8
# Tiles a launch-order table holds (csrc/flash_attn_bwd.cu MAX_ORDER, two
# tables of 16-bit entries in the kernels' parameters); past it the kernels
# take key tiles in order and query tiles latest first.
MAX_ORDER = 512
# The pre-pass pads each (batch row, head)'s row records to whole tiles of
# this many rows (csrc/flash_attn_bwd.cu ROW_TILE), with {+inf, 0}, and
# stores a tile's lse column, then its delta column: a stage of the dK/dV
# ring takes one tile's records in one bulk copy.
ROW_TILE = 64
LOG2E = 1.4426950408889634


def row_pad(s: int) -> int:
    """``s`` query rows padded to whole :data:`ROW_TILE`-row tiles."""
    return -(-s // ROW_TILE) * ROW_TILE


def row_records_plain(out: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor) -> torch.Tensor:
    """The pre-pass's row records of the output and its gradient (B, H,
    S, Dv) and the forward's lse (B, H, S), in the kernels' layout: (B, H,
    :func:`row_pad` (S) / :data:`ROW_TILE`, 2, :data:`ROW_TILE`) float32,
    tile by tile ``[..., 0, :]`` lse times log2 e (in float32, as the
    kernels scale it) and ``[..., 1, :]`` delta = rowsum(dO * O) in
    float32 of the tile's rows; a padded row holds (+inf, 0), so that its
    p = 2^(s - inf) is 0."""
    b, h, s, _ = out.shape
    rec = torch.empty(b, h, row_pad(s), 2, dtype=torch.float32,
                      device=out.device)
    rec[..., 0] = float("inf")
    rec[..., 1] = 0.0
    rec[:, :, :s, 0] = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    rec[:, :, :s, 1] = (dout.float() * out.float()).sum(-1)
    return rec.view(b, h, -1, ROW_TILE, 2).transpose(-1, -2).contiguous()


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The wgmma kernels' tiling and grids, in launch order.  dK/dV block
    ``i`` takes the ``dkdv_keys`` keys of (batch row, KV head, key tile)
    ``dkdv_order[i]`` and walks ``dkdv_steps[i]`` (head, ``tile``-row
    query tile) steps; dQ block ``i`` takes the (batch row, head, query
    tile of ``dq_rows``) ``dq_order[i]`` and walks ``dq_steps[i]``
    ``tile``-key tiles.  ``head_group`` is the KV heads a launch group
    (0: none, every head in flight at once); ``dq_grid`` the dQ kernel's
    CUDA grid, (x, y) or, grouped, one axis in launch order.
    ``key_tiles`` and ``query_tiles`` are the tables the kernels read:
    the key tiles and the query tiles in launch order, longest walk first
    (empty past :data:`MAX_ORDER` tiles)."""
    tile: int
    dkdv_grid: int
    dkdv_order: tuple
    dkdv_steps: tuple
    dq_rows: int
    dq_grid: tuple
    dq_order: tuple
    dq_steps: tuple
    dkdv_keys: int = TILE
    head_group: int = 0
    key_tiles: tuple = ()
    query_tiles: tuple = ()

    @functools.cached_property
    def tables(self) -> tuple:
        """The two tables as the kernels' C arrays, each with its length."""
        return tuple(((ctypes.c_ushort * max(len(t), 1))(*t), len(t))
                     for t in (self.key_tiles, self.query_tiles))


def _grouped(b, n_heads, group, n_tiles, tiles):
    """(batch row, head, tile) in launch order: batch rows in turn, heads
    in groups of ``group``, and within a group ``tiles`` (an order of
    range(n_tiles)) tile by tile over the group's heads."""
    return tuple((bi, hi, tile) for bi in range(b)
                 for g0 in range(0, n_heads, group) for tile in tiles
                 for hi in range(g0, min(g0 + group, n_heads)))


def key_walk(kt: int, keys: int, s: int, t: int, causal: bool,
             window: int) -> tuple:
    """``(first, n)``: the key tile ``kt`` of ``keys`` keys walks the
    64-row query tiles ``first .. first + n - 1`` that see any of its
    keys: under causal masking from the tile holding its first key, under
    a sliding window up to the tile holding the last query its last key
    reaches (``csrc/flash_attn_bwd.cu``'s ``window_end``)."""
    n_qt = -(-s // TILE)
    first = min(kt * keys // TILE, n_qt) if causal else 0
    end = n_qt
    if window > 0:
        end = min(n_qt, (min((kt + 1) * keys, t) + window - 2) // TILE + 1)
    return first, max(0, end - first)


def query_walk(qt: int, s: int, t: int, causal: bool, window: int) -> tuple:
    """``(first, n)``: the dQ block of query tile ``qt`` (:data:`DQ_ROWS`
    rows) walks the 64-key tiles ``first .. first + n - 1``: under a
    sliding window from the tile of its first row's first visible key
    (``window_start``), under causal masking up to its last row's key."""
    q0 = qt * DQ_ROWS
    end = -(-t // TILE)
    if causal:
        end = min(end, (min(q0 + DQ_ROWS, s) - 1) // TILE + 1)
    first = max(0, q0 - window + 1) // TILE if window > 0 else 0
    return first, max(0, end - first)


@functools.lru_cache(maxsize=128)
def bwd_plan(b: int, h: int, hk: int, s: int, t: int, d: int,
             causal: bool, dv: int | None = None,
             window: int = 0) -> BwdPlan:
    """The grids of the bfloat16 wgmma kernels at (d, dv) (dv defaults to
    d) in :data:`WGMMA_DIMS` for q (b, h, s, d), k (b, hk, t, d) and v
    (b, hk, t, dv), causal or not, under a sliding ``window`` or none.  A
    dK/dV block takes one tile of 64 keys (128 at (192, 128)) of one
    (batch row, KV head) and walks the group's h / hk heads times the
    64-row query tiles that see it (:func:`key_walk`): under causal
    masking those from the tile's first key on, so without a window a
    64-key tile j walks h / hk (n - j) of them.  Blocks launch key tile by
    key tile, the longest walks first (the earliest tile first among
    equals), so that the short tiles fill in behind the long ones as
    multiprocessors free (one block a multiprocessor, as the kernels'
    shared memory allows).  A dQ block takes 128 query rows of one (batch
    row, head) and walks the 64-key tiles they see (:func:`query_walk`),
    the longest walks first (the latest query tile first among equals).
    Without a window these are the key tiles in order and the query tiles
    latest first; under one the walks shrink to the window's reach, and
    the tables the kernels read give the order.  At (192, 128) both grids
    launch in groups of :data:`HEAD_GROUP` KV heads (for dQ the query
    heads that read them), that order within each group."""
    dv = d if dv is None else dv
    if (d, dv) not in WGMMA_DIMS:
        raise ValueError(f"bwd_plan: the wgmma kernels take (D, Dv) in "
                         f"{WGMMA_DIMS}, not ({d}, {dv})")
    if min(b, h, hk, s, t) <= 0 or h % hk:
        raise ValueError(f"bwd_plan: no plan for b={b} h={h} hk={hk} s={s} "
                         f"t={t}")
    if window < 0 or (window > 0 and s > t):
        raise ValueError(f"bwd_plan: a window of {window} at s={s} t={t} "
                         f"(a window needs 0 < s <= t)")
    g = h // hk
    keys, group = (2 * TILE, HEAD_GROUP) if d != dv else (TILE, 0)
    n_kt, n_q = -(-t // keys), -(-s // DQ_ROWS)
    k_walk = [key_walk(kt, keys, s, t, causal, window)[1]
              for kt in range(n_kt)]
    q_walk = [query_walk(qt, s, t, causal, window)[1] for qt in range(n_q)]
    # Longest walk first: the earliest key tile, the latest query tile
    # among equals (the order of before the tables, in which the kernels
    # past MAX_ORDER take them).
    kts = (sorted(range(n_kt), key=lambda kt: (-k_walk[kt], kt))
           if n_kt <= MAX_ORDER else list(range(n_kt)))
    qts = (sorted(range(n_q), key=lambda qt: (-q_walk[qt], -qt))
           if n_q <= MAX_ORDER else list(range(n_q - 1, -1, -1)))
    if group:
        order = _grouped(b, hk, group, n_kt, kts)
        dq_order = _grouped(b, h, group * g, n_q, qts)
        dq_grid = (len(dq_order),)
    else:
        order = tuple((bi, hi, kt) for kt in kts for bi in range(b)
                      for hi in range(hk))
        dq_order = tuple((x // h, x % h, qt)
                         for qt in qts for x in range(b * h))
        dq_grid = (b * h, n_q)
    return BwdPlan(
        tile=TILE, dkdv_grid=len(order), dkdv_order=order,
        dkdv_steps=tuple(g * k_walk[kt] for _, _, kt in order),
        dq_rows=DQ_ROWS, dq_grid=dq_grid, dq_order=dq_order,
        dq_steps=tuple(q_walk[qt] for _, _, qt in dq_order),
        dkdv_keys=keys, head_group=group,
        key_tiles=tuple(kts) if n_kt <= MAX_ORDER else (),
        query_tiles=tuple(qts) if n_q <= MAX_ORDER else ())


def check_supported(d: int, dv: int, window: int = 0, s: int = 0,
                    t: int = 0) -> None:
    """Raise ``ValueError`` naming what the backward kernels do not take: a
    (D, Dv) pair outside :data:`repro_torch.kernels.flash_attn.PAIRS`, or
    what the forward refuses of a sliding window (a negative one, or one
    over ``s`` query rows past ``t`` keys)."""
    if (d, dv) not in PAIRS:
        raise ValueError(f"flash_attention has a backward at (D, Dv) in "
                         f"{PAIRS}, not at ({d}, {dv})")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if window and s > t:
        raise ValueError(f"flash_attention: a window needs S <= T, got S "
                         f"{s}, T {t}")


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True,
                              scale: float | None = None,
                              window: int = 0) -> tuple:
    """``(dq, dk, dv)`` in the operands' dtype, from autograd through the
    float32 reference attention."""
    grads = ref.flash_attention_bwd(q, k, v, dout, causal=causal,
                                    scale=scale, window=window)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _strides(*tensors):
    """The kernels' 24 strides (batch, head, row of each tensor) as a C
    array, after checking each tensor's layout."""
    names = ("q", "k", "v", "out", "dout", "dq", "dk", "dv")
    for name, t in zip(names, tensors):
        err = layout_error(t.shape, t.stride(), t.data_ptr())
        if err:
            raise ValueError(f"flash_attention_bwd: {name} {err}")
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None, window: int = 0,
                        dq: torch.Tensor | None = None,
                        dk: torch.Tensor | None = None,
                        dv: torch.Tensor | None = None) -> tuple:
    """``(dq, dk, dv)``, the gradients of attention over q (B, H, S, D), k
    (B, Hk, T, D) and v (B, Hk, T, Dv) (scale ``scale``, default ``D **
    -0.5``; causal masking by absolute position) against ``dout`` (B, H,
    S, Dv), given the forward's output ``out`` (B, H, S, Dv) and its row
    log-sum-exp ``lse`` (a contiguous (B, H, S) float32 tensor,
    ``flash_attn.flash_attention(..., lse=)`` under the same ``window``:
    query s sees key t only when s - t < window).  Writes
    into ``dq``, ``dk``, ``dv`` (any layout ``layout_error`` accepts, in
    the operands' dtype) where given.  CUDA tensors launch the kernels
    (float32 or bfloat16 operands of one dtype); CPU tensors take
    :func:`flash_attention_bwd_plain`, which needs neither ``out`` nor
    ``lse``.  A pair outside ``flash_attn.PAIRS``, a negative window or a
    window with S > T raises ``ValueError`` (:func:`check_supported`)
    before any launch."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_bwd needs q (B, H, S, D), k "
                         f"(B, Hk, T, D) and v (B, Hk, T, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t, d_v = k.shape[1], k.shape[2], v.shape[3]
    window = int(window)
    check_supported(d, d_v, window, s, t)
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention_bwd: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple of "
                         f"Hk)")
    for name, x in (("out", out), ("dout", dout)):
        if tuple(x.shape) != (b, h, s, d_v):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{(b, h, s, d_v)}, got {tuple(x.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    grads = {"dq": (dq, q), "dk": (dk, k), "dv": (dv, v)}
    for name, (g, like) in grads.items():
        if g is not None and (g.shape != like.shape or g.dtype != q.dtype
                              or g.device != q.device):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(like.shape)} {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        res = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                        scale=scale, window=window)
        return tuple(r if g is None else g.copy_(r)
                     for r, (g, _) in zip(res, grads.values()))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    if len({x.dtype for x in (q, k, v, out, dout)}) != 1 \
            or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 "
                        f"operands of one dtype, got "
                        f"{[x.dtype for x in (q, k, v, out, dout)]}")
    if (tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"({b}, {h}, {s}) float32 tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(like) if g is None else g
                  for g, like in grads.values())
    if 0 in (b, s, t):                  # nothing to launch
        for g in (dq, dk, dv):
            g.zero_()
        return dq, dk, dv
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    rows = torch.empty((b, h, row_pad(s) // ROW_TILE, 2, ROW_TILE),
                       dtype=torch.float32, device=q.device)
    plan = ()
    if q.dtype == torch.bfloat16:
        plan = (0, 0, 0, None, 0, None, 0)
        if (d, d_v) in WGMMA_DIMS:
            p = bwd_plan(b, h, hk, s, t, d, bool(causal), d_v, window)
            (kts, n_kts), (qts, n_qts) = p.tables
            plan = (p.dkdv_keys, p.head_group, p.dkdv_grid, kts, n_kts, qts,
                    n_qts)
    lib = _build.load("flash_attn_bwd", _SIGNATURES)
    _build.call(lib, "flash_attn_bwd", getattr(lib, _ENTRY[q.dtype]),
                q.device, *(x.data_ptr() for x in (q, k, v, out, dout, lse,
                                                   rows, dq, dk, dv)),
                strides, b, h, hk, s, t, d, d_v, scale, int(causal), window,
                *plan)
    LAUNCHES += 1
    return dq, dk, dv
