"""The scan backward's launch plan and index arithmetic
(``kernels/ssm_scan_bwd.py::bwd_plan``, ``csrc/ssm_scan_bwd.cu``), pure
Python: the walk's grid (channel blocks, chunks, batch rows) and the
pre-pass's, indexed as the kernels index them, own every (batch row,
channel, state, step) exactly once (the pre-pass: every step past the
first chunk); the warp sums of dB and dC (recursive halving over a warp's
channels) and of du (over a channel's lanes), transcribed, give every sum
once; the tile stager, by 16-byte and by 4-byte copies, fills every slot
of both kernels' stages once from the right element or with zeros.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import ssm_scan, ssm_scan_bwd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (Path(ssm_scan_bwd.__file__).resolve().parents[1] / "csrc"
          / "ssm_scan_bwd.cu").read_text()
STEPS = ssm_scan_bwd.STEPS
THREADS = ssm_scan.THREADS


def _walk_owned(plan, b, s, di, n) -> np.ndarray:
    """How many walk threads hold each (batch row, channel, state, step):
    block (bx, k, row) holds channels ``bx * CH + tid / L``, states from
    ``(tid % L) * N / L`` and the steps of tiles ``[k * chunk / 16,
    min(that + chunk / 16, ceil(S / 16)))`` below S."""
    count = np.zeros((b, di, n, s), dtype=np.int64)
    sl = n // plan.lanes
    n_tiles = -(-s // STEPS)
    bxs, ks, rows = plan.grid
    for row in range(rows):
        for k in range(ks):
            j_lo = k * (plan.chunk // STEPS)
            j_hi = min(j_lo + plan.chunk // STEPS, n_tiles)
            steps = [t for t in range(j_lo * STEPS, j_hi * STEPS) if t < s]
            for bx in range(bxs):
                for tid in range(THREADS):
                    ch = bx * plan.channels + tid // plan.lanes
                    if ch >= di:
                        continue
                    first = tid % plan.lanes * sl
                    count[row, ch, first:first + sl, steps] += 1
    return count


def _prepass_owned(plan, b, s, di, n) -> np.ndarray:
    """How many pre-pass threads hold each (batch row, channel, state,
    step): block (x, k - 1, row) holds chunk k, a warp 32 neighbouring
    channels ``x * PCH + tid / (32 G) * 32 + tid % 32`` and states from
    ``(tid / 32) % G * 8``, G = n / 8."""
    count = np.zeros((b, di, n, s), dtype=np.int64)
    groups = n // ssm_scan_bwd.PRE_STATES
    n_tiles = -(-s // STEPS)
    xs, ks, rows = plan.prepass_grid
    for row in range(rows):
        for y in range(ks):
            k = y + 1
            j_lo = k * (plan.chunk // STEPS)
            j_hi = min(j_lo + plan.chunk // STEPS, n_tiles)
            steps = [t for t in range(j_lo * STEPS, j_hi * STEPS) if t < s]
            for x in range(xs):
                for tid in range(THREADS):
                    ch = (x * plan.prepass_channels
                          + tid // (32 * groups) * 32 + tid % 32)
                    if ch >= di:
                        continue
                    s0 = tid // 32 % groups * ssm_scan_bwd.PRE_STATES
                    count[row, ch, s0:s0 + ssm_scan_bwd.PRE_STATES,
                          steps] += 1
    return count


@pytest.mark.parametrize("n", ssm_scan.STATES)
@pytest.mark.parametrize("b,s,di", [(1, 1, 33), (2, 100, 70), (1, 300, 200),
                                    (3, 64, 129)])
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_walk_and_prepass_own_every_step_once(n, b, s, di, chunk):
    """At the plan's lanes (n / 4): each (batch row, channel, state, step)
    is walked by exactly one thread, and the pre-pass takes each step past
    the first chunk exactly once and none of the first chunk's."""
    plan = ssm_scan_bwd.bwd_plan(b, s, di, n, chunk)
    assert plan.lanes == n // ssm_scan_bwd.LANE_STATES
    assert np.array_equal(_walk_owned(plan, b, s, di, n),
                          np.ones((b, di, n, s), dtype=np.int64))
    pre = _prepass_owned(plan, b, s, di, n)
    assert not pre[..., :chunk].any()
    assert (pre[..., chunk:] == 1).all()


def _channel_sum(v: np.ndarray, lanes: int) -> np.ndarray:
    """``channel_sum<L, M, P>`` over a warp: v (32, M), thread t at lane
    ``t % L`` of channel place ``cg = t / L``; shuffles read the partner's
    value of the same round.  Returns each thread's v[0]."""
    m, p = v.shape[1], 32 // lanes
    v = v.copy()
    cg = np.arange(32) // lanes
    half = m // 2
    while half >= 1:
        upper = (cg & half) != 0
        send = np.where(upper[:, None], v[:, :half], v[:, half:2 * half])
        keep = np.where(upper[:, None], v[:, half:2 * half], v[:, :half])
        partner = np.arange(32) ^ (half * lanes)
        v[:, :half] = keep + send[partner]
        half //= 2
    o = m
    while o < p:
        v[:, 0] = v[:, 0] + v[np.arange(32) ^ (o * lanes), 0]
        o *= 2
    return v[:, 0]


@pytest.mark.parametrize("n", ssm_scan.STATES)
def test_warp_sums_of_db_and_dc(n):
    """At the walk's n / 4 lanes: after the recursive halving, the thread
    at channel place cg < M holds value cg % M of its lane summed over
    the warp's channels, and those threads write each of the warp's 2 n
    (dB or dC, state) sums once, at ``(e / SL, lane * SL + e % SL)``."""
    rng = np.random.default_rng(n)
    lanes = n // ssm_scan_bwd.LANE_STATES
    sl = n // lanes
    m = 2 * sl
    v = rng.integers(-8, 8, (32, m)).astype(np.float64)
    got = _channel_sum(v, lanes)
    written = {}
    for t in range(32):
        cg, lane = t // lanes, t % lanes
        e = cg % m
        want = v[np.arange(32) % lanes == lane, e].sum()
        assert got[t] == want, (lanes, t)
        if cg < m:
            key = (e // sl, lane * sl + e % sl)
            assert key not in written
            written[key] = got[t]
    assert sorted(written) == [(q, i) for q in range(2) for i in range(n)]


@pytest.mark.parametrize("lanes", [n // ssm_scan_bwd.LANE_STATES
                                   for n in ssm_scan.STATES])
def test_lane_sums_of_du(lanes):
    """``lane_sum``, the forward's butterfly: lane l of a channel ends
    with step l's sum over the channel's lanes."""
    rng = np.random.default_rng(lanes)
    p = rng.integers(-8, 8, (lanes, lanes)).astype(np.float64)  # [lane][q]
    v = p.copy()
    half = lanes // 2
    while half >= 1:
        upper = (np.arange(lanes) & half) != 0
        send = np.where(upper[:, None], v[:, :half], v[:, half:2 * half])
        keep = np.where(upper[:, None], v[:, half:2 * half], v[:, :half])
        v[:, :half] = keep + send[np.arange(lanes) ^ half]
        half //= 2
    assert np.array_equal(v[:, 0], p.sum(0))


def _tile(ch, n, xb) -> dict:
    """``Tile<CH, N, XB>``'s regions of a stage, in floats: offset and
    length of dt, dy, x (XB), C, B (XB), and the stage's size."""
    rows, bc = STEPS * ch, STEPS * n
    c = (3 if xb else 2) * rows
    regions = {"dt": (0, rows), "dy": (rows, rows), "C": (c, bc)}
    if xb:
        regions.update(x=(2 * rows, rows), B=(c + bc, bc))
    return dict(regions, size=c + (2 if xb else 1) * bc)


def _stage(ch, n, xb, vec, b, t0, s, di, ch0) -> list:
    """``stage<Tile<CH, N, XB>>`` over a block's 128 threads: every copy
    as (operand, stage slot, global element or None for a zero fill)."""
    lay = _tile(ch, n, xb)
    rows_ops = ["dt", "dy"] + (["x"] if xb else [])
    bc_ops = ["C"] + (["B"] if xb else [])
    row0 = b * s + t0
    copies = []
    for tid in range(THREADS):
        if vec:
            q_n = ch // 4
            rows, bc = STEPS * q_n, STEPS * n // 4
            for k in range(-(-rows // THREADS)):
                q = tid + k * THREADS
                if rows % THREADS == 0 or q < rows:
                    r, c = q // q_n, q % q_n * 4
                    inside = t0 + r < s and ch0 + c < di
                    for op in rows_ops:
                        for i in range(4):
                            copies.append((op, lay[op][0] + r * ch + c + i,
                                           (row0 + r) * di + ch0 + c + i
                                           if inside else None))
            if tid < bc:
                inside = t0 + tid * 4 // n < s
                for op in bc_ops:
                    for i in range(4):
                        copies.append((op, lay[op][0] + tid * 4 + i,
                                       row0 * n + tid * 4 + i
                                       if inside else None))
        else:
            for e in range(tid, STEPS * ch, THREADS):
                r, c = e // ch, e % ch
                inside = t0 + r < s and ch0 + c < di
                for op in rows_ops:
                    copies.append((op, lay[op][0] + e,
                                   (row0 + r) * di + ch0 + c
                                   if inside else None))
            for e in range(tid, STEPS * n, THREADS):
                inside = t0 + e // n < s
                for op in bc_ops:
                    copies.append((op, lay[op][0] + e,
                                   row0 * n + e if inside else None))
    return copies


# (16-byte copies, S, d_inner, first step, channel block): a whole tile,
# the last tile ragged in steps and in channels; the 4-byte copies also
# at an odd d_inner.
STAGE_CASES = [(True, 40, 64, 0, 0), (True, 300, 200, 288, -1),
               (True, 20, 36, 16, 0), (False, 40, 64, 0, 0),
               (False, 300, 200, 288, -1), (False, 50, 33, 48, 0),
               (False, 15, 33, 0, -1)]


@pytest.mark.parametrize("n", ssm_scan.STATES)
@pytest.mark.parametrize("kernel", ["walk", "prepass"])
@pytest.mark.parametrize("vec,s,di,t0,blk", STAGE_CASES)
def test_stage_fills_every_slot_once(n, kernel, vec, s, di, t0, blk):
    """The walk's stage (dt, dy, x of its 128 / (n / 4) channels, B and C)
    and the pre-pass's (dt, dy of its 128 / (n / 8) channels, C), by
    16-byte copies (d_inner a multiple of 4, as the C entry asks) and by
    4-byte ones: every slot of the stage written once, from step r and
    channel c's element where both lie inside, else zero-filled."""
    if kernel == "walk":
        ch, xb = THREADS // (n // ssm_scan_bwd.LANE_STATES), True
    else:
        ch, xb = THREADS // (n // ssm_scan_bwd.PRE_STATES), False
    blocks = -(-di // ch)
    ch0 = (blocks - 1 if blk < 0 else blk) * ch
    b = 1
    lay = _tile(ch, n, xb)
    copies = _stage(ch, n, xb, vec, b, t0, s, di, ch0)
    slots = sorted(slot for _, slot, _ in copies)
    assert slots == list(range(lay["size"]))
    for op, slot, src in copies:
        off = slot - lay[op][0]
        assert 0 <= off < lay[op][1], (op, slot)
        if op in ("C", "B"):
            r = off // n
            want = (b * s + t0) * n + off
        else:
            r, c = divmod(off, ch)
            want = (b * s + t0 + r) * di + ch0 + c \
                if ch0 + c < di else None
        assert src == (want if t0 + r < s else None), (op, off)


def test_source_matches_the_transcriptions():
    """The kernels' index arithmetic and sums are the ones the tests
    above transcribe."""
    for line in ("const int k = blockIdx.y + 1, nk = gridDim.y + 1, "
                 "b = blockIdx.z;",
                 "const int s0 = (tid / 32) % G * PRE_STATES;",
                 "const int ch = blockIdx.x * PCH + tid / (32 * G) * 32 "
                 "+ tid % 32;",
                 "const int j_lo = k * (chunk / STEPS);",
                 "const int bx = blockIdx.x, k = blockIdx.y, "
                 "nk = gridDim.y;",
                 "const int ch0 = bx * CH;", "const int cl = tid / L;",
                 "const int lane = tid % L;", "const int cg = cl % P;",
                 "const int ch = ch0 + cl;", "const bool live = ch < DI;",
                 "const int j_hi = min(j_lo + chunk / STEPS, n_tiles);",
                 "const int e = cg % M;",
                 "red[((warp * 2 + e / SL) * STEPS + r) * N + lane * SL "
                 "+ e % SL] =",
                 "v[q] = keep + __shfl_xor_sync(0xffffffffu, send, "
                 "HALF * L);",
                 "halve<L, M, HALF / 2>(v, cg);",
                 "halve<L, M, M / 2>(v, cg);",
                 "v[0] += __shfl_xor_sync(0xffffffffu, v[0], o * L);",
                 "const dim3 grid((g.DI + Sh::CH - 1) / Sh::CH, g.chunks, "
                 "g.B);",
                 "const dim3 grid((g.DI + PCH - 1) / PCH, g.chunks - 1, "
                 "g.B);",
                 "constexpr int PCH = THREADS / (N / PRE_STATES);",
                 "static constexpr int DY = STEPS * CH;",
                 "static constexpr int X = 2 * STEPS * CH;",
                 "static constexpr int C = (XB ? 3 : 2) * STEPS * CH;",
                 "static constexpr int B = C + STEPS * N;",
                 "static constexpr int SIZE = C + (XB ? 2 : 1) * STEPS * N;",
                 "using Lay = Tile<PCH, N, false>;",
                 "using Lay = Tile<CH, N, true>;",
                 "static constexpr int L = N / SL;",
                 "constexpr int Q = CH / 4;",
                 "const int r = q / Q, c = (q % Q) * 4;",
                 "const bool in = t0 + r < S && ch0 + c < DI;",
                 "const long long off = in ? (row0 + r) * DI + ch0 + c : 0;",
                 "const bool in = t0 + q * 4 / N < S;",
                 "const long long off = in ? row0 * N + q * 4 : 0;",
                 "const int r = e / CH, c = e % CH;",
                 "const bool in = t0 + e / N < S;",
                 "const long long off = in ? row0 * N + e : 0;"):
        assert line in SOURCE, line
    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.global", SOURCE)
    assert int(re.search(r"constexpr int PRE_STATES = (\d+);",
                         SOURCE).group(1)) == ssm_scan_bwd.PRE_STATES
