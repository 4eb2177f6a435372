"""The attention backward's grid plan (``flash_attn_bwd.bwd_plan``) on the
CPU: the bfloat16 wgmma kernels at D 64 and 128 launch the grids it
returns, so that which block takes which tile, and in what order, is
checked here without the card."""
import heapq
import itertools

import numpy as np
import pytest

from repro_torch.kernels import flash_attn_bwd

TRAIN = (1, 32, 8, 2048, 2048, 128)       # Qwen3-4B's training attention
SMS = 132                                 # the H100 SXM's multiprocessors


def makespan(costs, sms=SMS):
    """When the last of blocks of these costs ends, each block taken in
    launch order by the first multiprocessor that is free (one block a
    multiprocessor, as the wgmma kernels' shared memory allows)."""
    free = [0] * min(sms, len(costs))
    end = 0
    for c in costs:
        t = heapq.heappop(free) + c
        end = max(end, t)
        heapq.heappush(free, t)
    return end


def _visible(s, t, causal):
    """The (query, key) pairs attention keeps: all, or key <= query."""
    if not causal:
        return np.ones((s, t), dtype=bool)
    return np.arange(t)[None, :] <= np.arange(s)[:, None]


def _tiles(n, size):
    return [slice(i * size, min((i + 1) * size, n))
            for i in range(-(-n // size))]


SHAPES = [(bb, h, hk, s, t, causal)
          for (s, t), (h, hk), bb, causal in itertools.product(
              [(77, 77), (300, 300), (1000, 1000), (130, 200)],
              [(8, 8), (8, 2), (8, 1)], [1, 2], [True, False])]


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES)
def test_every_key_tile_once_with_the_steps_that_see_it(b, h, hk, s, t,
                                                        causal):
    """Each (batch row, KV head, key tile) is one dK/dV block, the longest
    walks first, and a block walks exactly the (head, query tile) pairs
    that see any of its keys."""
    plan = flash_attn_bwd.bwd_plan(b, h, hk, s, t, 128, causal)
    n_kt = -(-t // plan.tile)
    assert plan.dkdv_grid == len(plan.dkdv_order) == len(plan.dkdv_steps)
    assert sorted(plan.dkdv_order) == [
        (bi, hi, kt) for bi in range(b) for hi in range(hk)
        for kt in range(n_kt)]
    vis = _visible(s, t, causal)
    for (_, _, kt), steps in zip(plan.dkdv_order, plan.dkdv_steps):
        keys = _tiles(t, plan.tile)[kt]
        seen = sum(vis[rows, keys].any() for rows in _tiles(s, plan.tile))
        assert steps == (h // hk) * seen
    assert list(plan.dkdv_steps) == sorted(plan.dkdv_steps, reverse=True)


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES)
def test_dq_blocks_longest_first_over_the_keys_they_see(b, h, hk, s, t,
                                                        causal):
    """Each (batch row, head, 128-row query tile) is one dQ block; it
    walks the key tiles up to the last one its rows see, and the blocks
    launch longest walk first."""
    plan = flash_attn_bwd.bwd_plan(b, h, hk, s, t, 64, causal)
    n_q = -(-s // plan.dq_rows)
    assert plan.dq_grid == (b * h, n_q)
    assert len(plan.dq_order) == len(plan.dq_steps) == b * h * n_q
    assert sorted(plan.dq_order) == [(bi, hi, qt) for bi in range(b)
                                     for hi in range(h) for qt in range(n_q)]
    vis = _visible(s, t, causal)
    key_tiles = _tiles(t, plan.tile)
    for (_, _, qt), steps in zip(plan.dq_order, plan.dq_steps):
        rows = _tiles(s, plan.dq_rows)[qt]
        seen = [kt for kt, keys in enumerate(key_tiles)
                if vis[rows, keys].any()]
        assert steps == max(seen) + 1
    assert list(plan.dq_steps) == sorted(plan.dq_steps, reverse=True)


def test_training_shape_fills_the_card():
    """At Qwen3-4B's training shape no block walks more than 1.1x the mean
    steps a multiprocessor, and taken in launch order the grids end
    within 1.1x of that mean."""
    plan = flash_attn_bwd.bwd_plan(*TRAIN, True)
    mean = sum(plan.dkdv_steps) / SMS
    assert max(plan.dkdv_steps) <= 1.1 * mean
    assert makespan(plan.dkdv_steps) <= 1.1 * mean
    assert makespan(plan.dq_steps) <= 1.1 * sum(plan.dq_steps) / SMS
    # 8 KV heads x 32 key tiles, tile j walking 4 heads x (32 - j) query
    # tiles: 16,896 steps, 128 a multiprocessor, and tile 0's 128.
    assert (plan.dkdv_grid, sum(plan.dkdv_steps),
            makespan(plan.dkdv_steps)) == (256, 16896, 128)


def test_longest_first_ends_before_pairing_the_triangle():
    """Pairing key tile j with tile n - 1 - j in one block (equal walks)
    ends later than the plan's longest-first order at the training
    shape: a pair walks as far as tile 0 alone and a head group more."""
    plan = flash_attn_bwd.bwd_plan(*TRAIN, True)
    steps = dict(zip(plan.dkdv_order, plan.dkdv_steps))
    n = max(kt for _, _, kt in plan.dkdv_order) + 1
    pairs = [steps[(0, hk, j)] + steps[(0, hk, n - 1 - j)]
             for j in range(n // 2) for hk in range(8)]
    assert makespan(pairs) > makespan(plan.dkdv_steps)


def test_makespan_takes_blocks_in_launch_order():
    assert makespan([3, 3, 2, 2, 2], sms=2) == 7
    assert makespan([5, 1, 1, 1, 1, 1], sms=2) == 5
    assert makespan([4], sms=132) == 4


@pytest.mark.parametrize("d", [8, 16, 32, 40, 80, 192])
def test_plan_only_at_the_wgmma_widths(d):
    with pytest.raises(ValueError, match="wgmma"):
        flash_attn_bwd.bwd_plan(1, 2, 2, 64, 64, d, True)


def test_plan_refuses_a_head_count_hk_does_not_divide():
    with pytest.raises(ValueError):
        flash_attn_bwd.bwd_plan(1, 6, 4, 64, 64, 64, True)


# DeepSeek-V3's training attention at multi-head latent attention's (D,
# Dv) = (192, 128): 128 heads, each its own KV head, 2048 rows.
MLA_TRAIN = (1, 128, 128, 2048, 2048)


def _pair_plan(b, h, hk, s, t, causal):
    return flash_attn_bwd.bwd_plan(b, h, hk, s, t, 192, causal, dv=128)


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES)
def test_pair_key_tiles_once_with_the_steps_that_see_them(b, h, hk, s, t,
                                                         causal):
    """At (192, 128) each (batch row, KV head, 128-key tile) is one dK/dV
    block, and it walks exactly the (head, 64-row query tile) pairs that
    see any of its keys."""
    plan = _pair_plan(b, h, hk, s, t, causal)
    assert (plan.dkdv_keys, plan.tile) == (128, 64)
    n_kt = -(-t // plan.dkdv_keys)
    assert plan.dkdv_grid == len(plan.dkdv_order) == len(plan.dkdv_steps)
    assert sorted(plan.dkdv_order) == [
        (bi, hi, kt) for bi in range(b) for hi in range(hk)
        for kt in range(n_kt)]
    vis = _visible(s, t, causal)
    for (_, _, kt), steps in zip(plan.dkdv_order, plan.dkdv_steps):
        keys = _tiles(t, plan.dkdv_keys)[kt]
        seen = sum(vis[rows, keys].any() for rows in _tiles(s, plan.tile))
        assert steps == (h // hk) * seen


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES)
def test_pair_dq_blocks_walk_the_keys_they_see(b, h, hk, s, t, causal):
    """At (192, 128) each (batch row, head, 128-row query tile) is one dQ
    block on a one-axis grid, and it walks the 64-key tiles up to the last
    one its rows see."""
    plan = _pair_plan(b, h, hk, s, t, causal)
    n_q = -(-s // plan.dq_rows)
    assert plan.dq_grid == (b * h * n_q,)
    assert sorted(plan.dq_order) == [(bi, hi, qt) for bi in range(b)
                                     for hi in range(h) for qt in range(n_q)]
    vis = _visible(s, t, causal)
    key_tiles = _tiles(t, plan.tile)
    for (_, _, qt), steps in zip(plan.dq_order, plan.dq_steps):
        rows = _tiles(s, plan.dq_rows)[qt]
        seen = [kt for kt, keys in enumerate(key_tiles)
                if vis[rows, keys].any()]
        assert steps == max(seen) + 1


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES + [
    (1, 128, 128, 2048, 2048, True), (2, 24, 12, 300, 300, True)])
def test_pair_launches_head_group_by_head_group(b, h, hk, s, t, causal):
    """At (192, 128) both grids take batch rows in turn and KV heads in
    groups of ``HEAD_GROUP`` (for dQ the query heads that read them), every
    block of a group before the next group's; within a group dK/dV blocks
    go key tile by key tile and dQ blocks latest query tile first, so the
    longest walks of each group lead it."""
    plan = _pair_plan(b, h, hk, s, t, causal)
    group, g = plan.head_group, h // hk
    assert group == flash_attn_bwd.HEAD_GROUP == 8
    for order, steps, per in ((plan.dkdv_order, plan.dkdv_steps, 1),
                              (plan.dq_order, plan.dq_steps, g)):
        keys = [(bi, hi // (group * per)) for bi, hi, _ in order]
        runs = [key for i, key in enumerate(keys)
                if i == 0 or keys[i - 1] != key]
        assert len(runs) == len(set(runs))          # one run a group
        assert runs == sorted(runs)
        for key in runs:
            mine = [i for i, k in enumerate(keys) if k == key]
            assert [steps[i] for i in mine] == sorted(
                (steps[i] for i in mine), reverse=True)


def _decode_dkdv(x, hk, n_kt, group):
    """bwd_dkdv_wgmma's block -> (batch row, KV head, key tile) at (192,
    128), as csrc/flash_attn_bwd.cu writes it."""
    b, rem = divmod(x, hk * n_kt)
    g0 = rem // (group * n_kt) * group
    gs = min(group, hk - g0)
    kt, off = divmod(rem - g0 * n_kt, gs)
    return b, g0 + off, kt


def _decode_dq(x, h, hk, n_q, group):
    """bwd_dq_wgmma's block -> (batch row, head, query tile) at (192,
    128), as csrc/flash_attn_bwd.cu writes it."""
    gh = group * (h // hk)
    b, rem = divmod(x, h * n_q)
    h0 = rem // (gh * n_q) * gh
    gs = min(gh, h - h0)
    qi, off = divmod(rem - h0 * n_q, gs)
    return b, h0 + off, n_q - 1 - qi


@pytest.mark.parametrize("b,h,hk,s,t,causal", SHAPES + [
    (1, 128, 128, 2048, 2048, True), (2, 24, 12, 300, 300, True),
    (1, 20, 20, 129, 129, False)])
def test_pair_kernels_decode_the_plans_order(b, h, hk, s, t, causal):
    """The kernels find their block's tile from blockIdx.x alone; that
    arithmetic gives the plan's order block for block."""
    plan = _pair_plan(b, h, hk, s, t, causal)
    n_kt = -(-t // plan.dkdv_keys)
    n_q = -(-s // plan.dq_rows)
    assert [_decode_dkdv(x, hk, n_kt, plan.head_group)
            for x in range(plan.dkdv_grid)] == list(plan.dkdv_order)
    assert [_decode_dq(x, h, hk, n_q, plan.head_group)
            for x in range(plan.dq_grid[0])] == list(plan.dq_order)


def _heads_in_flight(order, sms=SMS):
    """The most (batch row, head) pairs among any ``sms`` blocks launched
    one after another."""
    return max(len({(bi, hi) for bi, hi, _ in order[i:i + sms]})
               for i in range(max(1, len(order) - sms + 1)))


def test_pair_training_shape_fills_the_card_and_keeps_heads_in_l2():
    """At DeepSeek-V3's training shape, taken in launch order both grids
    end within 1.03x of the mean steps a multiprocessor, and any 132
    blocks launched one after another read the operands of 16 heads (at
    most 24: their Q and dO, or K and V, 1.31 MB a head, ~21 MB of the 50
    MB L2), where the (D, D) order would hold all 128."""
    plan = _pair_plan(*MLA_TRAIN, True)
    for steps in (plan.dkdv_steps, plan.dq_steps):
        assert makespan(steps) <= 1.03 * sum(steps) / SMS
    # 128 heads x 16 key tiles, tile j walking 32 - 2 j query tiles.
    assert (plan.dkdv_grid, sum(plan.dkdv_steps), max(plan.dkdv_steps)) \
        == (2048, 34816, 32)
    assert _heads_in_flight(plan.dkdv_order) == 16
    assert _heads_in_flight(plan.dq_order) == 16
    flat = flash_attn_bwd.bwd_plan(*MLA_TRAIN, 128, True)
    assert _heads_in_flight(flat.dkdv_order) == 128


def test_plan_at_d_d_is_the_plan_without_dv():
    """Giving Dv = D changes nothing: the (D, D) plans keep 64-key blocks
    and every head in flight."""
    for d in (64, 128):
        assert flash_attn_bwd.bwd_plan(*TRAIN[:5], d, True, dv=d) \
            == flash_attn_bwd.bwd_plan(*TRAIN[:5], d, True)
    plan = flash_attn_bwd.bwd_plan(*TRAIN, True)
    assert (plan.dkdv_keys, plan.head_group, plan.dq_grid) == (64, 0,
                                                               (32, 16))


@pytest.mark.parametrize("d,dv", [(192, 192), (192, 64), (128, 192),
                                  (24, 16)])
def test_plan_refuses_pairs_without_wgmma_kernels(d, dv):
    with pytest.raises(ValueError, match="wgmma"):
        flash_attn_bwd.bwd_plan(1, 2, 2, 64, 64, d, True, dv=dv)


# Under a sliding window: Hymba-1.5B's training attention (25 heads on 5
# KV heads, 2048 rows, window 1024) and small shapes with windows short
# and long against the tiles.
WINDOW_SHAPES = [(b, h, hk, s, s, causal, w)
                 for (b, h, hk), s, causal, w in itertools.product(
                     [(1, 5, 1), (2, 4, 2)], [77, 300, 1100],
                     [True, False], [1, 7, 63, 64, 65, 130, 1000, 1100])]


def _visible_window(s, t, causal, window):
    """The pairs the forward keeps: key <= query under causal masking,
    and query - key < window."""
    lag = np.arange(s)[:, None] - np.arange(t)[None, :]
    keep = lag < window
    return keep & (lag >= 0) if causal else keep


@pytest.mark.parametrize("d,dv", [(64, 64), (192, 128)])
@pytest.mark.parametrize("b,h,hk,s,t,causal,window", WINDOW_SHAPES)
def test_window_walks_count_the_kept_pairs_longest_first(b, h, hk, s, t,
                                                         causal, window, d,
                                                         dv):
    """Under a window each dK/dV block walks exactly the (head, query
    tile) pairs that keep any of its keys, each dQ block the key tiles
    from the first its rows keep to the last, and both grids launch
    longest walk first."""
    plan = flash_attn_bwd.bwd_plan(b, h, hk, s, t, d, causal, dv, window)
    vis = _visible_window(s, t, causal, window)
    key_tiles = _tiles(t, plan.tile)
    for (_, _, kt), steps in zip(plan.dkdv_order, plan.dkdv_steps):
        keys = _tiles(t, plan.dkdv_keys)[kt]
        seen = [qt for qt, rows in enumerate(_tiles(s, plan.tile))
                if vis[rows, keys].any()]
        assert seen == list(range(seen[0], seen[-1] + 1)) if seen else True
        assert steps == (h // hk) * len(seen)
    for (_, _, qt), steps in zip(plan.dq_order, plan.dq_steps):
        rows = _tiles(s, plan.dq_rows)[qt]
        seen = [kt for kt, keys in enumerate(key_tiles)
                if vis[rows, keys].any()]
        assert steps == seen[-1] - seen[0] + 1
    if not plan.head_group:
        assert list(plan.dkdv_steps) == sorted(plan.dkdv_steps, reverse=True)
        assert list(plan.dq_steps) == sorted(plan.dq_steps, reverse=True)


@pytest.mark.parametrize("b,h,hk,s,t,causal,window", WINDOW_SHAPES)
def test_window_tables_are_what_the_kernels_decode(b, h, hk, s, t, causal,
                                                   window):
    """The kernels read the tile of a block's rank from the plan's two
    tables: at (D, D) key tile ``key_tiles[x / (B Hk)]`` and query tile
    ``query_tiles[y]``; at (192, 128) the grouped decoders' ranks index
    the same tables.  Both tables hold every tile once."""
    flat = flash_attn_bwd.bwd_plan(b, h, hk, s, t, 64, causal, 64, window)
    assert sorted(flat.key_tiles) == list(range(-(-t // 64)))
    assert sorted(flat.query_tiles) == list(range(-(-s // 128)))
    assert [(x % (b * hk) // hk, x % (b * hk) % hk,
             flat.key_tiles[x // (b * hk)])
            for x in range(flat.dkdv_grid)] == list(flat.dkdv_order)
    n_q = flat.dq_grid[1]
    assert [(x // h, x % h, flat.query_tiles[y]) for y in range(n_q)
            for x in range(b * h)] == list(flat.dq_order)
    pair = _pair_plan_window(b, h, hk, s, t, causal, window)
    n_kt, n_q = -(-t // pair.dkdv_keys), -(-s // pair.dq_rows)
    dk = [_decode_dkdv(x, hk, n_kt, pair.head_group)
          for x in range(pair.dkdv_grid)]
    assert [(bi, hi, pair.key_tiles[r]) for bi, hi, r in dk] \
        == list(pair.dkdv_order)
    dq = [_decode_dq(x, h, hk, n_q, pair.head_group)
          for x in range(pair.dq_grid[0])]
    assert [(bi, hi, pair.query_tiles[n_q - 1 - r]) for bi, hi, r in dq] \
        == list(pair.dq_order)


def _pair_plan_window(b, h, hk, s, t, causal, window):
    return flash_attn_bwd.bwd_plan(b, h, hk, s, t, 192, causal, 128, window)


def test_without_a_window_the_tables_are_the_order_of_before():
    """Window 0 keeps the orders of the kernels' arithmetic before the
    tables: key tiles in order, query tiles latest first."""
    for causal in (True, False):
        plan = flash_attn_bwd.bwd_plan(*TRAIN, causal)
        assert plan.key_tiles == tuple(range(32))
        assert plan.query_tiles == tuple(range(15, -1, -1))
        assert plan == flash_attn_bwd.bwd_plan(*TRAIN, causal, window=0)


def test_hymba_training_window_shrinks_the_walks():
    """At Hymba-1.5B's training attention (1, 25 / 5 heads, 2048 rows, D
    64, causal, window 1024) a 64-key tile walks at most 17 query tiles of
    its window (5 heads: 85 steps) against 32 without it, and a dQ block
    at most 18 key tiles; the grids' sums fall to the window's share of
    the causal triangle."""
    shape = (1, 25, 5, 2048, 2048, 64, True)
    win = flash_attn_bwd.bwd_plan(*shape, window=1024)
    full = flash_attn_bwd.bwd_plan(*shape)
    assert max(win.dkdv_steps) == 5 * 17 and max(full.dkdv_steps) == 5 * 32
    assert max(win.dq_steps) == 18 and max(full.dq_steps) == 32
    assert sum(win.dkdv_steps) < 0.8 * sum(full.dkdv_steps)
    assert makespan(win.dkdv_steps) <= 1.1 * sum(win.dkdv_steps) / SMS


def test_past_max_order_the_kernels_take_the_arithmetic_order():
    n = flash_attn_bwd.MAX_ORDER + 1
    plan = flash_attn_bwd.bwd_plan(1, 1, 1, 128 * n, 64 * n, 64, True)
    assert plan.key_tiles == () and plan.query_tiles == ()
    assert [kt for _, _, kt in plan.dkdv_order] == list(range(n))


def test_plan_refuses_a_window_it_cannot_take():
    with pytest.raises(ValueError, match="window"):
        flash_attn_bwd.bwd_plan(1, 2, 2, 128, 64, 64, True, window=16)
    with pytest.raises(ValueError, match="window"):
        flash_attn_bwd.bwd_plan(1, 2, 2, 64, 64, 64, True, window=-1)
