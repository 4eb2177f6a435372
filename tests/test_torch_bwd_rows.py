"""The attention backward's row records on the CPU
(``flash_attn_bwd.row_records_plain``, what the pre-pass of
``csrc/flash_attn_bwd.cu`` writes): each (batch, head) padded to whole
64-row tiles with (+inf, 0), lse scaled by log2 e in float32, delta the
float32 row sum of dO * O, against numpy; the backward driven from the
records (``tests/attention_rows.py``) against the autograd reference, and
the two faults the card tests plant in it (a record one tile off, a
skipped (head, query tile) item) beyond the bf16 checks' bound; and the
source's constants against the wrapper's (the record's tile and layout,
the C entry's parameters, each wgmma kernel's shared memory within a
block's).
The card runs the kernels against the same plain versions
(``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch
from attention_rows import SRC, bwd_from_records, source_int, wgmma_rings, \
    wgmma_smem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.kernels import flash_attn_bwd, ref

# The card tests' bound on a bf16 gradient, by its largest element.
BF16_TOL = 2e-2


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130, 2048])
def test_row_records_against_numpy(s):
    rng = np.random.default_rng(s)
    out = rng.standard_normal((2, 3, s, 24)).astype(np.float32)
    dout = rng.standard_normal((2, 3, s, 24)).astype(np.float32)
    lse = rng.uniform(-4.0, 9.0, (2, 3, s)).astype(np.float32)
    tiled = flash_attn_bwd.row_records_plain(
        *(torch.from_numpy(x) for x in (out, dout, lse))).numpy()
    pad = -(-s // 64) * 64
    assert tiled.shape == (2, 3, pad // 64, 2, 64)
    assert tiled.dtype == np.float32
    assert flash_attn_bwd.row_pad(s) == pad
    # Tile by tile, the lse column and then the delta column.
    rec = tiled.transpose(0, 1, 2, 4, 3).reshape(2, 3, pad, 2)
    np.testing.assert_array_equal(
        rec[:, :, :s, 0], lse * np.float32(1.4426950408889634))
    np.testing.assert_allclose(
        rec[:, :, :s, 1],
        (out.astype(np.float64) * dout.astype(np.float64)).sum(-1),
        rtol=1e-5, atol=1e-5)
    assert np.isposinf(rec[:, :, s:, 0]).all()
    assert (rec[:, :, s:, 1] == 0.0).all()


def _case(s, causal, window, seed=0, h=4, hk=2, d=16):
    gen = torch.Generator().manual_seed(seed)
    q = 0.5 * torch.randn(1, h, s, d, generator=gen)
    k = 0.5 * torch.randn(1, hk, s, d, generator=gen)
    v = torch.randn(1, hk, s, d, generator=gen)
    do = torch.randn(1, h, s, d, generator=gen)
    kw = dict(causal=causal, window=window)
    out = ref.flash_attention(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    rec = flash_attn_bwd.row_records_plain(out, do, lse)
    want = ref.flash_attention_bwd(q, k, v, do, **kw)
    return (q, k, v, do, rec, kw), want


def _err(got, want):
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("window", [0, 7, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [130, 200])
def test_backward_from_the_records_is_the_reference(s, causal, window):
    (q, k, v, do, rec, kw), want = _case(s, causal, window)
    assert _err(bwd_from_records(q, k, v, do, rec, **kw), want) < 1e-5


@pytest.mark.parametrize("window", [0, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_a_record_one_tile_off_fails_the_bound(causal, window):
    """The records of the next (or the last) 64-row tile in place of each
    row's own move the gradients past the bf16 bound."""
    (q, k, v, do, rec, kw), want = _case(200, causal, window)
    for shift in (1, -1):
        off = torch.roll(rec, shift, dims=2)
        assert _err(bwd_from_records(q, k, v, do, off, **kw), want) \
            > BF16_TOL, shift


@pytest.mark.parametrize("item", [(0, 1, 1), (3, 2, 0), (1, 3, 1)])
def test_a_skipped_item_fails_the_bound(item):
    """One (head, query tile) item left out of a key tile's dK and dV
    (the diagonal tile, a tile a window reaches, the last of a walk)."""
    (q, k, v, do, rec, kw), want = _case(256, True, 150)
    got = bwd_from_records(q, k, v, do, rec, skip=item, **kw)
    assert _err(got[:1], want[:1]) < 1e-5          # dQ keeps every item
    assert _err(got[1:], want[1:]) > BF16_TOL


def test_source_matches_the_wrapper():
    """The record's tile, the C entries' parameters (the records' scratch
    where the pre-pass's delta was), and the wgmma kernels' shared memory
    from the source's constants, each within a block's 227 KB beside
    the static barriers."""
    assert source_int("ROW_TILE") == flash_attn_bwd.ROW_TILE == 64
    assert source_int("WG_TILE") == flash_attn_bwd.TILE
    for entry in ("flash_attn_bwd_bf16", "flash_attn_bwd_f32"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', SRC)
        params = [p.split()[-1].lstrip("*") for p in sig.group(1).split(",")]
        assert len(params) == len(flash_attn_bwd._SIGNATURES[entry])
        assert params[5:7] == ["lse", "rows"]
    for d, dv in flash_attn_bwd.WGMMA_DIMS:
        ring, dq_ring = wgmma_rings(d, dv)
        kv, dq = wgmma_smem(d, dv)
        assert kv + 8 * (1 + 2 * ring) <= 232448, (d, dv, kv)
        assert dq + 8 * (1 + 4 * dq_ring) <= 232448, (d, dv, dq)
        if d == dv:       # the partials go over K and V and over the ring
            tile = 64 * d * 2
            assert 128 * (d // 2) * 4 <= min(2 * tile, ring * 2 * tile)
