"""The selective scan's gradient on the CPU (``kernels/ssm_scan_bwd.py``):
the backward's launch plan (lanes, grid, checkpoints) at the training
shapes and every lane count, and its plain version (autograd through
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


def reverse_walk(dt, x, bm, cm, a, d, h0, dy, dh):
    """The kernel's algorithm in float64 numpy: checkpoints every 16
    steps, then tile by tile from the last, the tile's states recomputed
    from its checkpoint and the reverse recurrence walked through them."""
    b, s, di = x.shape
    tiles = -(-s // STEPS)
    ckpt = np.empty((b, tiles, di, a.shape[1]))
    h = h0.copy()
    for t in range(s):
        if t % STEPS == 0:
            ckpt[:, t // STEPS] = h
        h = (np.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
    g_next = dh.copy()
    out = {k: np.zeros(v.shape) for k, v in
           dict(dt=dt, x=x, b=bm, c=cm, a=a, d=d).items()}
    for j in range(tiles - 1, -1, -1):
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
    return (out["dt"], out["x"], out["b"], out["c"], out["a"], out["d"],
            g_next)


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


@pytest.mark.parametrize("b,s,di,n,lanes", [(1, 2048, 8192, 16, 4),
                                            (1, 2048, 3200, 16, 8),
                                            (2, 32, 128, 8, 4)])
def test_plan_at_the_training_shapes(b, s, di, n, lanes):
    """The forward's lane count (Falcon-Mamba-7B's and Hymba-1.5B's
    training micro-batches, and the smoke configs' two rows), one block a
    128 / lanes channels of a batch row, a checkpoint a 16-step tile."""
    plan = ssm_scan_bwd.bwd_plan(b, s, di, n)
    assert plan.lanes == lanes == ssm_scan.scan_plan(b, di, n).lanes
    assert plan.channels * plan.lanes == ssm_scan.THREADS
    assert plan.grid == (-(-di // plan.channels), b)
    assert plan.checkpoints == -(-s // 16)


@pytest.mark.parametrize("n", ssm_scan.STATES)
def test_plan_at_every_lane_count(n):
    for lanes in ssm_scan.lane_counts(n):
        plan = ssm_scan_bwd.bwd_plan(3, 100, 200, n, lanes)
        assert (plan.lanes, plan.checkpoints) == (lanes, 7)
        assert plan.grid[0] * plan.channels >= 200 > (
            plan.grid[0] - 1) * plan.channels
    with pytest.raises(ValueError, match="lanes"):
        ssm_scan_bwd.bwd_plan(1, 16, 64, n, n)       # one state a lane
    with pytest.raises(ValueError):
        ssm_scan_bwd.bwd_plan(1, 16, 64, 4)


def test_checkpoint_count():
    assert [ssm_scan_bwd.checkpoints(s) for s in (0, 1, 16, 17, 2048)] == \
        [0, 1, 1, 2, 128]


def test_source_matches_the_wrapper():
    """The C entry's parameters are the ones the wrapper passes (twenty
    pointers, five ints, the stream), the block is the forward's 128
    threads, and a tile is the forward's 16-step checkpoint interval."""
    src = (Path(ssm_scan_bwd.__file__).resolve().parents[1] / "csrc"
           / "ssm_scan_bwd.cu").read_text()
    fwd = (Path(ssm_scan.__file__).resolve().parents[1] / "csrc"
           / "ssm_scan.cu").read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src).group(1)) \
        == ssm_scan.THREADS
    assert int(re.search(r"constexpr int STEPS = (\d+);", src).group(1)) \
        == STEPS == int(re.search(r"constexpr int SCAN_STEPS = (\d+);",
                                  fwd).group(1))
    sig = re.search(r'extern "C" int ssm_scan_bwd_f32\(([^)]*)\)', src)
    params = [p.split()[-1] for p in sig.group(1).split(",")]
    types = ssm_scan_bwd._SIGNATURES["ssm_scan_bwd_f32"]
    assert len(params) == len(types) == 26
    assert params[-6:] == ["B", "S", "DI", "N", "lanes", "stream"]
    assert params[8] == "dh_last" and params[6] == "ckpt"
    assert types[20:25] == [types[20]] * 5 and types[20] is not types[0]
