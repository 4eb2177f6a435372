"""Flash attention forward (the LM stack's prefill attention).

Replaces ``src/repro/kernels/flash_attn.py::flash_attention`` (Pallas
kernel ``_fa_kernel``).  The CUDA kernel (``csrc/flash_attn.cu``) takes
q (B, H, S, D), k (B, Hk, T, D) and v (B, Hk, T, Dv) with ``H`` a
multiple of ``Hk`` (query head ``h`` reads KV head ``h // (H // Hk)``),
float32 or bfloat16, ``(D, Dv)`` in :data:`PAIRS`, and a scale, and
returns (B, H, S, Dv) in q's dtype.  Each operand, and the output, may
be a strided view whose feature axis is contiguous (:func:`layout_error`
says what the kernel reads), so the model hands it its (B, S, H, D)
projections transposed, without a copy.  bfloat16 runs on the tensor
cores (``wgmma`` at D 64, 80, 128 and 192 and at (192, 128),
``mma.sync`` at 16 and 32), float32 at every pair and bfloat16 at D 8
and 40 and at (24, 16) in true float32 FMAs, register-tiled (no TF32);
each of the three takes the models' sliding window (the hybrid
family's), starting a query tile's kv loop at the first tile its first
row sees.  :data:`HEAD_DIMS` holds the head widths of the repo's
configs: 64 and 128 (most of them), 80 (hubert-xlarge), 192
(nemotron-4-340b), the smoke configs' 8 and 16, and 40
(``examples/train_lm.py``'s ``10m`` scale); :data:`PAIRS` adds
DeepSeek-V3's multi-head latent attention, keys of 128 + 64 rope
features against values of 128, and its smoke config's (16 + 8, 16).
At the serving path's prefill it is bound by tensor-core operations.
The ``wgmma`` kernel runs on a persistent grid, one block a
multiprocessor walking the (head, query tile) items that
:func:`fwd_plan` gives it in a static order (no counter to reset, so a
CUDA graph replays the launch as it is): under causal masking without a
window each head's query tiles ``n - 1 - p`` and ``p`` in one block,
head by head, so that the heads in flight keep their K and V in L2;
otherwise the longest walks first.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention` cast to q's dtype, the
path for CPU tensors and the kernel's oracle on the card.

Each kernel can also write the rows' log-sum-exp (``lse``), from which
the backward kernels (:mod:`repro_torch.kernels.flash_attn_bwd`)
recompute the softmax; serving asks for none.  This wrapper has no
gradient: on the card it refuses operands that require one while grad is
enabled, rather than return an output that autograd cannot trace back
(``repro_torch.models.attention.flash_attention`` is the differentiable
entry, at the pairs the backward kernels take).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

# Kernel launches made by flash_attention; the plain path never counts.
LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 40, 64, 80, 128, 192)
# The (query/key width, value width) pairs the kernel computes.
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))

# q, k, v, out, lse (or null), their 12 strides, B, H, Hk, S, T, D, Dv,
# scale, causal, window, (bf16: the wgmma plan's rows, order and grid,)
# stream.
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
         + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
_SIGNATURES = {"flash_attn_f32": _ARGS + [ctypes.c_void_p],
               "flash_attn_bf16": _ARGS + [ctypes.c_int] * 3
               + [ctypes.POINTER(ctypes.c_ushort), ctypes.c_void_p]}
_SIGNATURES["flash_attn_wgmma_smem"] = [ctypes.c_int] * 2
_SIGNATURES["flash_attn_fma_smem"] = [ctypes.c_int] * 2
_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


# The (D, Dv) pairs that bfloat16 runs on the wgmma kernel, and its tile
# there: the query rows of an item (64 a consumer warpgroup, two of them)
# and the keys of a K/V tile.
WGMMA_TILES = {(64, 64): (128, 128), (80, 80): (128, 128),
               (128, 128): (128, 128), (192, 192): (128, 64),
               (192, 128): (128, 128)}
ORDER_PAIRS, ORDER_HEAVIEST = 0, 1
MAX_ORDER = 1024    # query tiles the kernel's longest-first table holds
SMS = 132           # the H100 SXM's multiprocessors


def fwd_walk(qt: int, rows: int, keys: int, s: int, t: int, causal: bool,
             window: int) -> tuple:
    """``(j0, n)``: query tile ``qt`` (rows ``qt * rows`` on) walks key
    tiles ``j0 .. j0 + n - 1``: under causal masking up to the tile of its
    last row's last key, under a sliding window from the tile of its first
    row's first key (``csrc/flash_attn.cu``'s ``item_tiles``)."""
    q0 = qt * rows
    n_kv = -(-t // keys)
    if causal:
        n_kv = min(n_kv, (min(q0 + rows, s) - 1) // keys + 1)
    j0 = max(0, q0 - window + 1) // keys if window > 0 else 0
    return j0, max(0, n_kv - j0)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The wgmma kernel's persistent grid: ``grid`` blocks, each taking
    slots ``0 .. rounds - 1`` of ``order`` (:data:`ORDER_PAIRS` or
    :data:`ORDER_HEAVIEST`) over ``n_qt`` query tiles of ``rows`` rows of
    ``bh`` heads, walking key tiles of ``keys`` rows (:meth:`item`);
    ``qts`` lists the query tiles longest walk first (the latest first
    among equals), which :data:`ORDER_HEAVIEST` follows."""
    rows: int
    keys: int
    order: int
    grid: int
    rounds: int
    n_qt: int
    bh: int
    qts: tuple

    def item(self, blk: int, i: int):
        """``(bh, qt)`` that block ``blk`` takes in slot ``i``, or None for
        an empty slot (``csrc/flash_attn.cu``'s ``sched_item``)."""
        if self.order == ORDER_PAIRS:
            npairs = (self.n_qt + 1) // 2
            u = (i // 2) * self.grid + blk
            if u >= self.bh * npairs:
                return None
            p = u % npairs
            if i % 2 and p == self.n_qt - 1 - p:
                return None
            return u // npairs, (self.n_qt - 1 - p if i % 2 == 0 else p)
        rank = i * self.grid + (blk if i % 2 == 0 else self.grid - 1 - blk)
        if rank >= self.bh * self.n_qt:
            return None
        return rank % self.bh, self.qts[rank // self.bh]

    def reordered(self, order: int, sms: int = SMS) -> "FwdPlan":
        """The same items in ``order``, on that order's grid."""
        units = self.bh * (self.n_qt if order == ORDER_HEAVIEST
                           else (self.n_qt + 1) // 2)
        grid = min(sms, units)
        return dataclasses.replace(
            self, order=order, grid=grid,
            rounds=-(-units // grid) * (1 if order == ORDER_HEAVIEST else 2))

    @functools.cached_property
    def qt_table(self):
        """``qts`` as the C array the kernel reads."""
        return (ctypes.c_ushort * len(self.qts))(*self.qts)

    def blocks(self) -> list:
        """Each block's items ``(bh, qt)`` in the order it walks them."""
        return [[x for x in (self.item(blk, i) for i in range(self.rounds))
                 if x is not None] for blk in range(self.grid)]


@functools.lru_cache(maxsize=256)
def fwd_plan(b: int, h: int, s: int, t: int, d: int, dv: int, causal: bool,
             window: int = 0, sms: int = SMS) -> FwdPlan:
    """The persistent grid of the bfloat16 wgmma kernel at ``(d, dv)`` in
    :data:`WGMMA_TILES` for q (b, h, s, d) and k, v (b, hk, t, ...): at most one block a
    multiprocessor (``sms``), the kernel's shared memory allows no more.
    Where each head's pair of query tiles n - 1 - p and p walks as many
    key tiles as any other pair (causal masking or none, no window) and
    there are more tiles than multiprocessors, blocks take such pairs head
    by head (:data:`ORDER_PAIRS`): every block walks the same number of
    key tiles, and the heads in flight at once, about ``sms`` / (n / 2),
    keep their K and V in L2 while all their query tiles read them.
    Otherwise (a window; a grid no larger than the card) the longest walks
    go first, in rounds of ``grid`` items that snake across the blocks
    (:data:`ORDER_HEAVIEST`), which evens the blocks' sums."""
    rows, keys = WGMMA_TILES[(d, dv)]
    if min(b, h, s, sms) <= 0 or t < 0:
        raise ValueError(f"fwd_plan: no plan for b={b} h={h} s={s} t={t}")
    n_qt, bh = -(-s // rows), b * h
    walks = [fwd_walk(qt, rows, keys, s, t, causal, window)[1]
             for qt in range(n_qt)]
    qts = tuple(sorted(range(n_qt), key=lambda qt: (-walks[qt], -qt))
                if n_qt <= MAX_ORDER else range(n_qt - 1, -1, -1))
    pair_sums = {walks[p] + walks[n_qt - 1 - p] for p in range(n_qt // 2)}
    pairs = window == 0 and len(pair_sums) <= 1 and bh * n_qt > sms
    return FwdPlan(rows, keys, ORDER_HEAVIEST, 0, 0, n_qt, bh, qts).reordered(
        ORDER_PAIRS if pairs else ORDER_HEAVIEST, sms)


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          window: int = 0) -> torch.Tensor:
    """The O(S^2) reference attention, in q's dtype."""
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window).to(q.dtype)


def layout_error(shape, strides, base: int):
    """Why the kernel cannot read (or write) an operand of this ``shape``
    and ``strides`` (elements) at address ``base``, or None.  The
    feature axis must be contiguous, the base 16-byte aligned, and the
    batch, head and sequence strides multiples of 8 elements, so that
    every 8-element pack of a row is one aligned 16-byte copy (axes of
    size 1 are never stepped, so their strides do not matter)."""
    if strides[-1] != 1:
        return f"has stride {strides[-1]} on its feature axis, not 1"
    if base % 16:
        return f"starts at {base}, not on a 16-byte boundary"
    bad = [st for size, st in zip(shape[:-1], strides[:-1])
           if size > 1 and st % 8]
    if bad:
        return f"has strides {tuple(strides)}, not multiples of 8 elements"
    return None


def _strides(*tensors):
    """The kernel's 12 strides (batch, head, sequence of each tensor) as
    a C array, after checking each tensor's layout."""
    for name, t in zip(("q", "k", "v", "out"), tensors):
        err = layout_error(t.shape, t.stride(), t.data_ptr())
        if err:
            raise ValueError(f"flash_attention: {name} {err}")
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int = 0,
                    out: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over q (B, H, S, D), k (B, Hk, T, D) and v (B, Hk, T,
    Dv) with scale ``scale`` (default ``D ** -0.5``); causal masking by
    absolute position, and a sliding window where ``window > 0`` (query s
    sees key t only when s - t < window; on the card it needs S <= T, so
    that every row sees a key).  Writes into ``out`` ((B, H, S, Dv) in q's dtype,
    any layout :func:`layout_error` accepts) if given, else into a new
    tensor (laid out like q where Dv = D), and returns it.  CUDA tensors launch the
    kernel (float32 or bfloat16 operands of one dtype, ``(D, Dv)`` in
    :data:`PAIRS`, layouts that :func:`layout_error` accepts, and no
    operand that requires grad while grad is enabled; anything else
    raises); CPU tensors take the plain version in any layout.  ``lse``,
    a contiguous (B, H, S) float32 tensor on q's device, receives each
    row's log-sum-exp of its scaled scores (:func:`ref.attention_lse`)."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention needs q (B, H, S, D), k (B, Hk, "
                         f"T, D) and v (B, Hk, T, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple of "
                         f"Hk)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands must share one device")
    o_shape = (b, h, s, dv)
    if out is not None and (tuple(out.shape) != o_shape
                            or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out must be {o_shape} "
                         f"{q.dtype} on {q.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if lse is not None and (tuple(lse.shape) != (b, h, s)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous "
                         f"({b}, {h}, {s}) float32 tensor on {q.device}")
    scale = d ** -0.5 if scale is None else float(scale)
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                    window=window)
        if lse is not None:
            lse.copy_(ref.attention_lse(q, k, causal=causal, scale=scale,
                                        window=window))
        return res if out is None else out.copy_(res)
    if needs_grad(q, k, v):
        raise RuntimeError(
            "the flash_attention kernel has no gradient of its own: call "
            "repro_torch.models.attention.flash_attention (a backward at "
            "every pair, under a window too) or run under torch.no_grad()")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (d, dv) not in PAIRS:
        raise ValueError(f"flash_attention takes (D, Dv) in {PAIRS}, got "
                         f"({d}, {dv})")
    if window and s > t:
        raise ValueError(f"flash_attention: a window needs S <= T, got S "
                         f"{s}, T {t}")
    if out is None:
        out = torch.empty_like(q) if dv == d else q.new_empty(o_shape)
    plan = None
    if q.dtype == torch.bfloat16 and (d, dv) in WGMMA_TILES:
        plan = fwd_plan(b, h, s, t, d, dv, bool(causal), window,
                        sm_count(q.device.index))
    launch(q, k, v, out, lse, scale, causal, window, plan)
    LAUNCHES += 1
    return out


def launch(q, k, v, out, lse, scale: float, causal: bool, window: int,
           plan: FwdPlan | None) -> None:
    """One launch of the kernel on checked CUDA operands, the wgmma kernel
    on ``plan``'s grid (None for the other kernels)."""
    b, h, s, d = q.shape
    strides = _strides(q, k, v, out)
    lib = _build.load("flash_attn", _SIGNATURES)
    extra = ()
    if q.dtype == torch.bfloat16:
        extra = (0, 0, 0, None) if plan is None else (
            plan.rows, plan.order, plan.grid, plan.qt_table)
    _build.call(lib, "flash_attn", getattr(lib, _ENTRY[q.dtype]), q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), strides,
                b, h, k.shape[1], s, k.shape[2], d, v.shape[3], scale,
                int(causal), window, *extra)
