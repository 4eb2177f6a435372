"""The attention backward's algorithm from its row records, in plain
float32 torch: what ``csrc/flash_attn_bwd.cu`` computes once its pre-pass
has written each query row's record {lse * log2 e, delta}
(``flash_attn_bwd.row_records_plain``).  The CPU tests hold it to the
autograd reference, and the card tests plant two faults in it that the
kernel's checks must tell from the kernel: a record one 64-row tile off,
and one (head, query tile) item left out of a key tile's dK and dV.  Also
the wgmma kernels' shared memory from the source's constants, which the
CPU tests hold to the wrapper and to a block's limit."""
import re
from pathlib import Path

import torch

from repro_torch.kernels import flash_attn_bwd

TILE = flash_attn_bwd.TILE
SRC = (Path(flash_attn_bwd.__file__).resolve().parents[1] / "csrc"
       / "flash_attn_bwd.cu").read_text()


def source_int(name):
    """The value of ``constexpr int name`` in ``csrc/flash_attn_bwd.cu``."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def wgmma_rings(d, dv):
    """The stages of the dK/dV ring (Q, dO and records) and of the dQ
    ring (K, V) at (d, dv), as ``BwdShape`` sets them."""
    return (2 if d != dv else source_int("KV_STAGES"),
            source_int("DQ_STAGES"))


def wgmma_smem(d, dv):
    """(dK/dV, dQ) dynamic shared memory in bytes of the wgmma kernels at
    (d, dv), ``BwdShape``'s ``KV_SMEM`` and ``DQ_SMEM`` from the source's
    constants: 64-row tiles, d wide for Q and K and dv for dO and V; dK/dV
    keeps its keys' K and V (128 keys at a pair d != dv, which adds each
    consumer's float32 and bf16 score tiles), the ring's stages with 64
    records of 8 bytes each; dQ its 128 rows of Q and dO and the ring's K
    and V; 1 KB to align."""
    tile, tile_v = 64 * d * 2, 64 * dv * 2
    split = d != dv
    ring, dq_ring = wgmma_rings(d, dv)
    kv = ((2 if split else 1) * (tile + tile_v)
          + ring * (tile + tile_v + 2 * 64 * 4)
          + (2 * 64 * 64 * (4 + 4) if split else 0) + 1024)
    return kv, (2 + dq_ring) * (tile + tile_v) + 1024


def bwd_from_records(q, k, v, dout, rec, *, causal=True, scale=None,
                     window=0, skip=None, bf16=False):
    """``(dq, dk, dv)`` float32 of attention over q (B, H, S, D), k (B,
    Hk, T, D) and v (B, Hk, T, Dv) against ``dout`` (B, H, S, Dv), from
    the row records ``rec`` in the kernels' layout (B, H, tiles, 2, 64;
    ``flash_attn_bwd.row_records_plain``): with row i's lse * log2 e l_i
    and delta d_i, P = 2^(s scale log2 e - l_i) on the pairs the mask
    keeps (causal: key <= query; a sliding ``window > 0``: query - key <
    window), dS = P (dP - d_i), dQ = scale dS K, dK = scale dS^T Q, dV =
    P^T dO.
    ``skip = (h, qt, kt)`` leaves query tile ``qt`` of head ``h`` out of
    dK and dV of key tile ``kt`` (64 rows each).  ``bf16`` rounds P (for
    dV) and dS (for dQ and dK) to bf16 before their products, as the
    bf16 kernels do."""
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5 if scale is None else float(scale)
    qf, of = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    lag = (torch.arange(s)[:, None] - torch.arange(t)[None, :]).to(q.device)
    keep = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        keep &= lag >= 0
    if window > 0:
        keep &= lag < window
    sl2 = torch.tensor(scale * flash_attn_bwd.LOG2E, dtype=torch.float32)
    lse2, delta = (rec[:, :, :, j].reshape(b, h, -1)[:, :, :s, None]
                   for j in (0, 1))
    p = torch.exp2(qf @ kf.transpose(-1, -2) * sl2 - lse2)
    p = torch.where(keep, p, torch.zeros((), device=q.device))
    ds = p * (of @ vf.transpose(-1, -2) - delta)
    if bf16:
        p, ds = (x.bfloat16().float() for x in (p, ds))
    dq = scale * (ds @ kf)
    if skip is not None:
        hh, qt, kt = skip
        rows = slice(qt * TILE, (qt + 1) * TILE)
        keys = slice(kt * TILE, (kt + 1) * TILE)
        p, ds = p.clone(), ds.clone()
        p[:, hh, rows, keys] = 0.0
        ds[:, hh, rows, keys] = 0.0
    dk = scale * (ds.transpose(-1, -2) @ qf)
    dv = p.transpose(-1, -2) @ of
    return (dq, dk.reshape(b, hk, g, t, d).sum(2),
            dv.reshape(b, hk, g, t, v.shape[3]).sum(2))


def row_errs(got, want) -> list:
    """Each gradient's largest error in a row over the larger of that
    row's largest element and 2^-6 of the largest row's (the row metric
    of ``chip_smoke.grad_row_err``): a fault confined to a few rows is
    measured against those rows, not against the whole gradient."""
    out = []
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs().amax(dim=-1)
        rows = w.float().abs().amax(dim=-1)
        out.append((diff / rows.clamp_min(rows.max() * 2.0 ** -6))
                   .max().item())
    return out
