"""The attention forward's persistent grid (``flash_attn.fwd_plan``) on
the CPU: the bfloat16 wgmma kernel walks the items its plan names
(``csrc/flash_attn.cu``'s ``sched_item`` is :meth:`FwdPlan.item`'s twin),
so which block takes which (head, query tile), in what order, and how
evenly the blocks are loaded is checked here without the card."""
import itertools

import numpy as np
import pytest

from repro_torch.kernels import flash_attn
from torch_threads import one_torch_thread  # noqa: F401

SMS = flash_attn.SMS
# (B, H, S, (D, Dv), causal, window) of the LM stack's prefill attention:
# DeepSeek-V3 (MLA), Hymba-1.5B (its window 1024), Qwen3-4B.
DEEPSEEK = (4, 128, 2048, (192, 128), True, 0)
HYMBA = (4, 25, 2048, (64, 64), True, 1024)
QWEN = (4, 32, 2048, (128, 128), True, 0)


def _kept(s, t, causal, window):
    """The (query, key) pairs the mask keeps."""
    lag = np.arange(s)[:, None] - np.arange(t)[None, :]
    keep = np.ones((s, t), dtype=bool)
    if causal:
        keep &= lag >= 0
    if window:
        keep &= lag < window
    return keep


def _walk(plan, qt, s, t, causal, window):
    return flash_attn.fwd_walk(qt, plan.rows, plan.keys, s, t, causal,
                               window)[1]


def _loads(plan, s, t, causal, window):
    """Each block's key tiles, summed over the items it walks."""
    return [sum(_walk(plan, qt, s, t, causal, window) for _, qt in items)
            for items in plan.blocks()]


SHAPES = [(b, h, s, t, dv, causal, window)
          for (b, h), (s, t), (dv, causal, window) in itertools.product(
              [(4, 128), (4, 25), (1, 3), (2, 32)],
              [(2048, 2048), (1000, 1000), (77, 77), (2047, 2047),
               (300, 500)],
              [((192, 128), True, 0), ((64, 64), True, 1024),
               ((64, 64), True, 1), ((64, 64), False, 64),
               ((128, 128), True, 0), ((80, 80), False, 0),
               ((192, 192), True, 0), ((64, 64), True, 4096)])]


@pytest.mark.parametrize("b,h,s,t,dv,causal,window", SHAPES)
def test_every_item_once_at_most_one_block_a_multiprocessor(b, h, s, t, dv,
                                                           causal, window):
    """Each (head, query tile) is one block's item exactly once, on a grid
    no larger than the card."""
    plan = flash_attn.fwd_plan(b, h, s, t, *dv, causal, window)
    items = [x for block in plan.blocks() for x in block]
    assert sorted(items) == [(bh, qt) for bh in range(b * h)
                             for qt in range(-(-s // plan.rows))]
    assert 1 <= plan.grid <= SMS and all(plan.blocks())
    assert (plan.rows, plan.keys) == flash_attn.WGMMA_TILES[dv]


@pytest.mark.parametrize("b,h,s,t,dv,causal,window", SHAPES)
def test_heaviest_first(b, h, s, t, dv, causal, window):
    """ORDER_HEAVIEST: the query tiles go longest walk first, so no item
    of a slot walks fewer key tiles than any item of a later slot.
    ORDER_PAIRS: every unit's two query tiles walk the same number of key
    tiles together, the heavier first."""
    plan = flash_attn.fwd_plan(b, h, s, t, *dv, causal, window)

    def walk(qt):
        return _walk(plan, qt, s, t, causal, window)
    walks = [walk(qt) for qt in plan.qts]
    assert sorted(plan.qts) == list(range(plan.n_qt))
    assert walks == sorted(walks, reverse=True)
    if plan.order == flash_attn.ORDER_HEAVIEST:
        slots = [[walk(x[1]) for blk in range(plan.grid)
                  for x in [plan.item(blk, i)] if x is not None]
                 for i in range(plan.rounds)]
        for now, later in zip(slots, slots[1:]):
            assert min(now) >= max(later)
        return
    assert window == 0 and plan.grid <= SMS
    n = plan.n_qt
    sums = {walk(p) + walk(n - 1 - p) for p in range(n // 2)}
    assert len(sums) <= 1
    for blk in range(plan.grid):
        for i in range(0, plan.rounds, 2):
            first, second = plan.item(blk, i), plan.item(blk, i + 1)
            if first is not None and second is not None:
                assert first[0] == second[0]
                assert walk(first[1]) >= walk(second[1])


@pytest.mark.parametrize("b,h,s,t,dv,causal,window", SHAPES)
def test_walks_cover_the_keys_the_mask_keeps(b, h, s, t, dv, causal,
                                             window):
    """A query tile walks the key tiles from the one holding its first
    row's first kept key to the one holding its last row's last: every
    kept pair lies in a walked tile."""
    plan = flash_attn.fwd_plan(b, h, s, t, *dv, causal, window)
    keep = _kept(s, t, causal, window)
    for qt in range(plan.n_qt):
        rows = keep[qt * plan.rows:(qt + 1) * plan.rows]
        cols = np.nonzero(rows.any(axis=0))[0]
        j0, n = flash_attn.fwd_walk(qt, plan.rows, plan.keys, s, t, causal,
                                    window)
        assert j0 * plan.keys <= cols.min()
        assert cols.max() < (j0 + n) * plan.keys
        assert (j0 + n - 1) * plan.keys <= cols.max()


@pytest.mark.parametrize("shape", [DEEPSEEK, HYMBA, QWEN])
def test_model_shapes_load_the_blocks_evenly(shape):
    """At the LM stack's prefill shapes the most loaded block walks within
    1.05x of the fair share (all key tiles over the 132
    multiprocessors)."""
    b, h, s, dv, causal, window = shape
    plan = flash_attn.fwd_plan(b, h, s, s, *dv, causal, window)
    loads = _loads(plan, s, s, causal, window)
    assert max(loads) <= 1.05 * sum(loads) / SMS


def test_deepseek_runs_head_by_head_in_pairs():
    """DeepSeek-V3: 512 heads of 16 query tiles make 4096 pairs of 17 key
    tiles, 31.03 a multiprocessor; the blocks walk 544 key tiles at most
    (1.031x the fair share), and the 132 pairs in flight at a slot belong
    to 17 heads (their K and V, 1.3 MB a head, stay in L2)."""
    b, h, s, dv, causal, window = DEEPSEEK
    plan = flash_attn.fwd_plan(b, h, s, s, *dv, causal, window)
    assert (plan.order, plan.grid, plan.rounds) == (flash_attn.ORDER_PAIRS,
                                                    132, 64)
    loads = _loads(plan, s, s, causal, window)
    assert max(loads) == 544 and sum(loads) == 4096 * 17
    for i in range(0, plan.rounds, 2):
        heads = {x[0] for x in (plan.item(blk, i) for blk in range(132))
                 if x is not None}
        assert len(heads) <= 17


def test_hymba_window_goes_longest_first():
    """Hymba-1.5B under its window: 100 heads of 16 query tiles of 128
    rows walking 1-9 key tiles, the longest walks first in 13 rounds that
    snake across the blocks; the most loaded block walks 83 key tiles
    against a fair share of 81.8."""
    b, h, s, dv, causal, window = HYMBA
    plan = flash_attn.fwd_plan(b, h, s, s, *dv, causal, window)
    assert (plan.order, plan.grid, plan.rounds, plan.n_qt) == (
        flash_attn.ORDER_HEAVIEST, 132, 13, 16)
    loads = _loads(plan, s, s, causal, window)
    assert max(loads) == 83 and 81.8 < sum(loads) / SMS < 81.9


@pytest.mark.parametrize("window", [1, 64, 1024, 2048, 4096])
def test_hymba_edge_windows_stay_within_a_stated_factor(window):
    """From one key to past S, the most loaded block walks within 1.15x of
    the fair share, or the longest single walk where that is larger."""
    b, h, s, dv, causal, _ = HYMBA
    plan = flash_attn.fwd_plan(b, h, s, s, *dv, causal, window)
    loads = _loads(plan, s, s, causal, window)
    longest = max(_walk(plan, qt, s, s, causal, window)
                  for qt in range(plan.n_qt))
    assert max(loads) <= max(1.15 * sum(loads) / SMS, longest)


def test_a_grid_smaller_than_the_card_gives_each_item_a_block():
    """Fewer items than multiprocessors: one item a block, longest first."""
    plan = flash_attn.fwd_plan(1, 8, 300, 300, 128, 128, True)
    assert plan.grid == 8 * 3 and plan.rounds == 1
    assert [len(items) for items in plan.blocks()] == [1] * 24
    assert [qt for items in plan.blocks() for _, qt in items] == \
        [2] * 8 + [1] * 8 + [0] * 8


def test_an_odd_number_of_query_tiles_walks_the_middle_once():
    plan = flash_attn.fwd_plan(2, 100, 5 * 128 - 3, 5 * 128 - 3, 128, 128,
                               True)
    assert plan.order == flash_attn.ORDER_PAIRS and plan.n_qt == 5
    items = [x for block in plan.blocks() for x in block]
    assert len(items) == len(set(items)) == 200 * 5


def test_the_sm_count_sets_the_grid():
    plan = flash_attn.fwd_plan(*DEEPSEEK[:2], 2048, 2048, 192, 128, True,
                               sms=114)
    assert plan.grid == 114
    items = [x for block in plan.blocks() for x in block]
    assert len(items) == len(set(items)) == 512 * 16


@pytest.mark.parametrize("args", [(0, 4, 64, 64, 64, 64, True),
                                  (1, 4, 0, 64, 64, 64, True),
                                  (1, 4, 64, 64, 16, 16, True)])
def test_plan_refuses_what_the_wgmma_kernel_does_not_run(args):
    with pytest.raises((ValueError, KeyError)):
        flash_attn.fwd_plan(*args)
