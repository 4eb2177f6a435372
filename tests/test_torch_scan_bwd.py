"""The selective scan's gradient on the CPU (``kernels/ssm_scan_bwd.py``):
the backward's launch plan (lanes, grid, checkpoints) at the training
shapes and at each n, and its plain version (autograd through
``ssm_scan_plain``) against an independent float64 transcription of the
kernel's algorithm: the forward's state at the start of every 16-step
tile, each tile's states recomputed from it and walked in reverse
(``csrc/ssm_scan_bwd.cu``), with h0 and the final state's gradient
nonzero and S no multiple of the checkpoint interval.  The card runs the
kernel against the same plain version (``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssm_scan, ssm_scan_bwd

STEPS = ssm_scan_bwd.STEPS


def _inputs(b, s, di, n, seed=0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, (b, s, di))
    x = rng.standard_normal((b, s, di))
    bm = rng.standard_normal((b, s, n))
    cm = rng.standard_normal((b, s, n))
    a = -np.exp(rng.uniform(0.0, 2.5, (di, n)))
    d = rng.standard_normal(di)
    h0 = rng.standard_normal((b, di, n))
    dy = rng.standard_normal((b, s, di))
    dh = rng.standard_normal((b, di, n))
    return dt, x, bm, cm, a, d, h0, dy, dh


def _checkpoints(dt, x, bm, a, h0):
    """The forward's state at the start of every 16-step tile."""
    b, s, di = x.shape
    ckpt = np.empty((b, -(-s // STEPS), di, a.shape[1]))
    h = h0.copy()
    for t in range(s):
        if t % STEPS == 0:
            ckpt[:, t // STEPS] = h
        h = (np.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
    return ckpt


def _walk_tiles(ops, ckpt, j_lo, j_hi, g_next, out):
    """Tiles ``j_hi - 1`` down to ``j_lo``, each tile's states recomputed
    from its checkpoint and the reverse recurrence walked through them
    from the carry ``g_next``: writes each step's d(dt), dx, dB and dC
    into ``out``, adds dA and dD there, returns the outgoing carry."""
    dt, x, bm, cm, a, d, _, dy = ops[:8]
    s = x.shape[1]
    for j in range(j_hi - 1, j_lo - 1, -1):
        t0, t1 = j * STEPS, min((j + 1) * STEPS, s)
        hs = [ckpt[:, j]]
        for t in range(t0, t1):
            hs.append(np.exp(dt[:, t, :, None] * a) * hs[-1]
                      + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        for t in range(t1 - 1, t0 - 1, -1):
            hp, hc = hs[t - t0], hs[t - t0 + 1]
            dec = np.exp(dt[:, t, :, None] * a)
            u = dt[:, t] * x[:, t]
            g = g_next + cm[:, t, None, :] * dy[:, t, :, None]
            du = (g * bm[:, t, None, :]).sum(-1)
            out["x"][:, t] = du * dt[:, t] + d * dy[:, t]
            out["dt"][:, t] = du * x[:, t] + (g * dec * hp * a).sum(-1)
            out["b"][:, t] = (g * u[..., None]).sum(1)
            out["c"][:, t] = (hc * dy[:, t, :, None]).sum(1)
            out["a"] += (g * dec * hp * dt[:, t, :, None]).sum(0)
            out["d"] += (x[:, t] * dy[:, t]).sum(0)
            g_next = g * dec
    return g_next


def _zeros(dt, x, bm, cm, a, d):
    return {k: np.zeros(v.shape) for k, v in
            dict(dt=dt, x=x, b=bm, c=cm, a=a, d=d).items()}


def reverse_walk(dt, x, bm, cm, a, d, h0, dy, dh):
    """The kernel's algorithm in float64 numpy: checkpoints every 16
    steps, then tile by tile from the last, the tile's states recomputed
    from its checkpoint and the reverse recurrence walked through them."""
    ops = (dt, x, bm, cm, a, d, h0, dy)
    out = _zeros(dt, x, bm, cm, a, d)
    ckpt = _checkpoints(dt, x, bm, a, h0)
    g0 = _walk_tiles(ops, ckpt, 0, ckpt.shape[1], dh.copy(), out)
    return (out["dt"], out["x"], out["b"], out["c"], out["a"], out["d"], g0)


def chunked_walk(dt, x, bm, cm, a, d, h0, dy, dh, chunk, *,
                 drop_carries=False):
    """The chunked kernels' order in float64 numpy
    (``csrc/ssm_scan_bwd.cu``): the pre-pass runs g <- C dy + exp(dt A) g
    over every chunk but the first from a zero carry, keeping the
    outgoing carry (``local``) and the decays' product (``prod``); each
    chunk's incoming carry folds the later chunks' in order, last first,
    from dh; then each chunk walks its tiles from that carry, its dA and
    dD kept apart (the kernel's partials) and added in chunk order; dh0
    is the first chunk's outgoing carry.  ``drop_carries`` plants a fault:
    each chunk walks from dh alone."""
    ops = (dt, x, bm, cm, a, d, h0, dy)
    b, s, di = x.shape
    n = a.shape[1]
    chunks = ssm_scan_bwd.chunk_count(s, chunk)
    tiles = chunk // STEPS
    local = np.zeros((b, chunks, di, n))
    prod = np.ones((b, chunks, di, n))
    for k in range(1, chunks):
        carry = np.zeros((b, di, n))
        for t in range(min((k + 1) * chunk, s) - 1, k * chunk - 1, -1):
            dec = np.exp(dt[:, t, :, None] * a)
            carry = (cm[:, t, None, :] * dy[:, t, :, None] + carry) * dec
            prod[:, k] *= dec
        local[:, k] = carry
    ckpt = _checkpoints(dt, x, bm, a, h0)
    out = _zeros(dt, x, bm, cm, a, d)
    da, dd = [], []
    for k in range(chunks):
        carry = dh.copy()
        for q in range(chunks - 1, k, -1):
            if not drop_carries:
                carry = local[:, q] + prod[:, q] * carry
        part = dict(out, a=np.zeros(a.shape), d=np.zeros(d.shape))
        g = _walk_tiles(ops, ckpt, k * tiles,
                        min((k + 1) * tiles, ckpt.shape[1]), carry, part)
        da.append(part["a"])
        dd.append(part["d"])
        if k == 0:
            g0 = g
    return (out["dt"], out["x"], out["b"], out["c"], sum(da), sum(dd), g0)


@pytest.mark.parametrize("b,s,di,n", [(1, 37, 12, 8), (2, 16, 8, 16),
                                      (2, 300, 6, 8), (1, 5, 4, 16)])
def test_plain_gradient_matches_the_reverse_walk(b, s, di, n):
    """Every gradient of the plain version (float32 autograd through the
    chunked scan) against the float64 reverse walk, to 1e-4 of each
    gradient's largest element: the two sum in other orders, in other
    precisions."""
    ops = _inputs(b, s, di, n)
    want = reverse_walk(*ops)
    got = ssm_scan_bwd.ssm_scan_bwd_plain(
        *(torch.tensor(o, dtype=torch.float32) for o in ops))
    names = ("dt", "x", "B", "C", "A", "D", "h0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)


def test_plain_gradient_without_the_final_state():
    """dh absent is dh zero (training never reads the final state)."""
    ops = [torch.tensor(o, dtype=torch.float32)
           for o in _inputs(1, 40, 8, 8, seed=3)]
    none = ssm_scan_bwd.ssm_scan_bwd_plain(*ops[:8])
    zero = ssm_scan_bwd.ssm_scan_bwd_plain(*ops[:8], torch.zeros_like(ops[8]))
    for a, z in zip(none, zero):
        assert torch.equal(a, z)
    want = reverse_walk(*_inputs(1, 40, 8, 8, seed=3)[:8],
                        np.zeros((1, 8, 8)))
    assert np.abs(none[6].numpy() - want[6]).max() < 1e-4 * np.abs(
        want[6]).max()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    ops = [torch.tensor(o, dtype=torch.float32)
           for o in _inputs(2, 21, 8, 8, seed=5)]
    before = ssm_scan_bwd.LAUNCHES
    got = ssm_scan_bwd.ssm_scan_bwd(*ops)
    want = ssm_scan_bwd.ssm_scan_bwd_plain(*ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssm_scan_bwd.LAUNCHES == before
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd.ssm_scan_bwd(*ops[:7], ops[7][:, :-1])


def test_plain_scan_is_differentiable_and_keeps_its_values():
    """The plain scan stacks its states (autograd refuses ``out=``), and
    under autograd gives the same bits as without it."""
    ops = [torch.tensor(o, dtype=torch.float32)
           for o in _inputs(1, 300, 4, 8, seed=7)[:7]]
    y0, h0 = ssm_scan.ssm_scan_plain(*ops)
    live = [t.clone().requires_grad_(True) for t in ops]
    y1, h1 = ssm_scan.ssm_scan_plain(*live)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,s,di,n", [(1, 37, 6, 8), (2, 16, 4, 16),
                                      (1, 300, 5, 16), (2, 129, 3, 8)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_chunked_order_equals_the_reverse_walk(b, s, di, n, chunk, with_dh):
    """The chunked kernels' order (pre-pass locals and decay products,
    the ordered carry pass, each chunk's walk from its carry, dA and dD
    in chunk order) against the tile-by-tile reverse walk, every gradient
    to 1e-12 of its largest element in float64: S below one chunk, at
    it and ragged past it, the final state's gradient present and
    absent."""
    ops = list(_inputs(b, s, di, n, seed=s + chunk))
    if not with_dh:
        ops[8] = np.zeros_like(ops[8])
    want = reverse_walk(*ops)
    got = chunked_walk(*ops, chunk)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "D", "h0"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(), name


def test_a_dropped_chunk_carry_is_seen():
    """The check is not blind to the carry pass: the same order with each
    chunk walking from dh alone (the later chunks' carries dropped) misses
    the reverse walk's gradients by far more than the tolerance."""
    ops = _inputs(1, 200, 4, 8, seed=9)
    want = reverse_walk(*ops)
    got = chunked_walk(*ops, 64, drop_carries=True)
    for name, g, w in zip(("dt", "x", "B", "A", "h0"),
                          [got[i] for i in (0, 1, 2, 4, 6)],
                          [want[i] for i in (0, 1, 2, 4, 6)]):
        assert np.abs(g - w).max() > 1e-6 * np.abs(w).max(), name


@pytest.mark.parametrize("b,s,di,n,lanes,chunk", [(1, 2048, 8192, 16, 4, 512),
                                                  (1, 2048, 3200, 16, 4, 128),
                                                  (2, 32, 128, 8, 2, 64)])
def test_plan_at_the_training_shapes(b, s, di, n, lanes, chunk):
    """Falcon-Mamba-7B's and Hymba-1.5B's training micro-batches, and the
    smoke configs' two rows: the fewest lanes whose states a lane keep
    their history in registers (n / 4), one block a 128 / lanes channels
    of a chunk of a batch row, a checkpoint a 16-step tile; the chunk the
    longest of ``CHUNK_STEPS`` whose walk has ``TARGET_BLOCKS`` blocks
    (1024 at Falcon-Mamba-7B, 1600 at Hymba-1.5B), else the shortest."""
    plan = ssm_scan_bwd.bwd_plan(b, s, di, n)
    assert plan.lanes == lanes == n // ssm_scan_bwd.LANE_STATES
    assert plan.channels * plan.lanes == ssm_scan.THREADS
    assert plan.chunk == chunk and plan.chunks == -(-s // chunk)
    assert plan.grid == (-(-di // plan.channels), plan.chunks, b)
    assert plan.prepass_grid == (-(-di // plan.prepass_channels),
                                 plan.chunks - 1, b)
    assert plan.checkpoints == -(-s // 16)
    if plan.chunk != ssm_scan_bwd.CHUNK_STEPS[0]:
        assert plan.blocks >= ssm_scan_bwd.TARGET_BLOCKS
    longer = [c for c in ssm_scan_bwd.CHUNK_STEPS if c > plan.chunk]
    for c in longer:
        assert ssm_scan_bwd.bwd_plan(b, s, di, n, chunk=c).blocks < \
            ssm_scan_bwd.TARGET_BLOCKS


@pytest.mark.parametrize("n", ssm_scan.STATES)
def test_plan_at_every_lane_count(n):
    """The walk's one lane count at each n: n / ``LANE_STATES`` (4
    states a lane), one of the forward's lane counts; the channel blocks
    cover d_inner with the last one ragged; another n is refused."""
    plan = ssm_scan_bwd.bwd_plan(3, 100, 200, n)
    lanes = n // ssm_scan_bwd.LANE_STATES
    assert (plan.lanes, plan.checkpoints) == (lanes, 7)
    assert lanes in ssm_scan.lane_counts(n)
    assert plan.grid[0] * plan.channels >= 200 > (
        plan.grid[0] - 1) * plan.channels
    assert plan.chunks == ssm_scan_bwd.chunk_count(100, plan.chunk)
    with pytest.raises(ValueError, match="n = 4"):
        ssm_scan_bwd.bwd_plan(1, 16, 64, 4)


@pytest.mark.parametrize("chunk", [0, -16, 8, 40, 100])
def test_plan_refuses_chunks_of_no_whole_tiles(chunk):
    with pytest.raises(ValueError, match="chunk"):
        ssm_scan_bwd.bwd_plan(1, 300, 64, 16, chunk=chunk)


def test_plan_picks_from_the_chunk_lengths():
    """Over batch rows 1-8, S 1-4096 and d_inner 1-16384 the plan's chunk
    is one of ``CHUNK_STEPS``, and at least one chunk covers any S."""
    for b in (1, 2, 4, 8):
        for s in (1, 15, 16, 17, 300, 2048, 4096):
            for di in (1, 200, 3200, 8192, 16384):
                plan = ssm_scan_bwd.bwd_plan(b, s, di, 16)
                assert plan.chunk in ssm_scan_bwd.CHUNK_STEPS
                assert plan.chunks == max(1, -(-s // plan.chunk))
                assert (plan.chunks - 1) * plan.chunk < max(s, 1)


def test_checkpoint_count():
    assert [ssm_scan_bwd.checkpoints(s) for s in (0, 1, 16, 17, 2048)] == \
        [0, 1, 1, 2, 128]
    assert [ssm_scan_bwd.chunk_count(s, 64) for s in (0, 1, 64, 65)] == \
        [1, 1, 1, 2]


def test_source_matches_the_wrapper():
    """The C entry's parameters are the ones the wrapper passes (22
    pointers, five ints, the stream), the block is the forward's 128
    threads, a tile is the forward's 16-step checkpoint interval, and a
    walk lane and a pre-pass thread hold the wrapper's states."""
    src = (Path(ssm_scan_bwd.__file__).resolve().parents[1] / "csrc"
           / "ssm_scan_bwd.cu").read_text()
    fwd = (Path(ssm_scan.__file__).resolve().parents[1] / "csrc"
           / "ssm_scan.cu").read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src).group(1)) \
        == ssm_scan.THREADS
    assert int(re.search(r"constexpr int STEPS = (\d+);", src).group(1)) \
        == STEPS == int(re.search(r"constexpr int SCAN_STEPS = (\d+);",
                                  fwd).group(1))
    assert int(re.search(r"constexpr int PRE_STATES = (\d+);",
                         src).group(1)) == ssm_scan_bwd.PRE_STATES
    assert int(re.search(r"constexpr int LANE_STATES = (\d+);",
                         src).group(1)) == ssm_scan_bwd.LANE_STATES
    sig = re.search(r'extern "C" int ssm_scan_bwd_f32\(([^)]*)\)', src)
    params = [p.split()[-1] for p in sig.group(1).split(",")]
    types = ssm_scan_bwd._SIGNATURES["ssm_scan_bwd_f32"]
    assert len(params) == len(types) == 28
    assert params[-6:] == ["B", "S", "DI", "N", "chunk", "stream"]
    assert params[8] == "dh_last" and params[6] == "ckpt"
    assert params[20:22] == ["local", "prod"]
    assert types[22:27] == [types[22]] * 5 and types[22] is not types[0]
