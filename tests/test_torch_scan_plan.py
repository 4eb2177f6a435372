"""The scan kernel's launch plan (``kernels/ssm_scan.py::scan_plan``),
pure Python: which lane count and grid the wrapper hands
``csrc/ssm_scan.cu``, and that the grid's threads, indexed as the kernel
indexes them (``_thread_cells``), own every (batch row, channel, state)
exactly once.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssm_scan

SOURCE = (Path(ssm_scan.__file__).resolve().parents[1] / "csrc"
          / "ssm_scan.cu").read_text()
MODEL_SHAPES = {"falcon-mamba-7b": ((4, 8192, 16), 1, 256),
                "hymba-1.5b": ((4, 3200, 16), 2, 200)}


def _thread_cells(plan, d_inner, n) -> tuple:
    """What each thread of ``plan``'s grid owns in ``ssm_scan_kernel``:
    arrays over (batch row, block, thread) of its channel (``blockIdx.x
    * CH + threadIdx.x / L``), its first state (``(threadIdx.x % L) * N /
    L``; it holds ``N / L`` from there) and whether the channel exists
    (``ch < DI``)."""
    bx, rows = plan.grid
    block = np.arange(bx)[None, :, None]
    tid = np.arange(ssm_scan.THREADS)[None, None, :]
    shape = (rows, bx, ssm_scan.THREADS)
    channel = np.broadcast_to(block * plan.channels + tid // plan.lanes,
                              shape)
    first = np.broadcast_to((tid % plan.lanes) * (n // plan.lanes), shape)
    return channel, first, channel < d_inner


def _owned(plan, b, d_inner, n) -> np.ndarray:
    """How many threads of ``plan``'s grid hold each state of each
    (batch row, channel), as a (b, d_inner, n) count."""
    channel, first, live = _thread_cells(plan, d_inner, n)
    rows = np.broadcast_to(np.arange(plan.grid[1])[:, None, None],
                           channel.shape)
    cells = []
    for i in range(n // plan.lanes):
        cells.append(((rows * d_inner + channel) * n + first + i)[live])
    return np.bincount(np.concatenate(cells),
                       minlength=b * d_inner * n).reshape(b, d_inner, n)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d_inner", [1, 33, 300, 3200, 8192])
def test_plan_covers_every_state_once(d_inner, b, n):
    """The planned grid, and the grid at every other lane count the
    kernel has, gives each state of each (batch row, channel) to exactly
    one thread; threads past d_inner hold nothing."""
    plan = ssm_scan.scan_plan(b, d_inner, n)
    assert plan == ssm_scan.plan_for(b, d_inner, plan.lanes)
    for lanes in ssm_scan.lane_counts(n):
        grid = ssm_scan.plan_for(b, d_inner, lanes)
        assert grid.channels * lanes == ssm_scan.THREADS
        assert grid.grid[1] == b
        assert (grid.grid[0] - 1) * grid.channels < d_inner
        assert np.array_equal(_owned(grid, b, d_inner, n),
                              np.ones((b, d_inner, n), dtype=np.int64))


@pytest.mark.parametrize("config", sorted(MODEL_SHAPES))
def test_plan_fills_the_card_at_the_model_shapes(config):
    """Falcon-Mamba-7B's prefill scan takes 1 lane (256 blocks),
    Hymba-1.5B's 2 (200 blocks): at least 132 blocks and 1.5 warps for
    each of the H100's 528 schedulers, where one thread a channel gave
    Hymba 100 blocks and 0.76 warps a scheduler."""
    (b, d_inner, n), lanes, blocks = MODEL_SHAPES[config]
    plan = ssm_scan.scan_plan(b, d_inner, n)
    assert (plan.lanes, plan.blocks) == (lanes, blocks)
    assert plan.blocks >= 132
    assert plan.warps_per_scheduler >= ssm_scan.WARPS_PER_SCHEDULER
    one = ssm_scan.plan_for(b, d_inner, 1)
    assert one.blocks == b * -(-d_inner // 128)
    if lanes > 1:
        assert one.warps_per_scheduler < ssm_scan.WARPS_PER_SCHEDULER


@pytest.mark.parametrize("n", [8, 16])
def test_plan_never_splits_below_two_states(n):
    """Every lane count the plan picks holds 2 states a lane or more and
    is one the kernel instantiates, over batch rows 1-64 and d_inner
    1-32768; it is the fewest lanes whose grid has 1.5 warps for each
    scheduler, else the most there are."""
    counts = ssm_scan.lane_counts(n)
    assert all(n // lanes >= 2 for lanes in counts)
    assert counts == tuple(c for c in (1, 2, 4, 8) if n // c >= 2)
    want = ssm_scan.WARPS_PER_SCHEDULER * ssm_scan.SCHEDULERS * 32
    for b in (1, 2, 3, 4, 5, 8, 16, 64):
        for d_inner in (1, 7, 33, 128, 300, 1024, 3200, 5000, 8192, 32768):
            lanes = ssm_scan.scan_plan(b, d_inner, n).lanes
            assert lanes in counts and n // lanes >= 2
            fills = [c for c in counts if b * d_inner * c >= want]
            assert lanes == (fills[0] if fills else counts[-1])


@pytest.mark.parametrize("n", [0, 4, 12, 32])
def test_plan_rejects_other_state_widths(n):
    with pytest.raises(ValueError, match="states"):
        ssm_scan.scan_plan(4, 3200, n)


def test_launch_never_runs_cpu_tensors():
    """``launch`` is the kernel alone: CPU operands raise, with no
    launch counted (``ssm_scan`` takes the plain version for them)."""
    gen = np.random.default_rng(0)
    b, s, di, n = 1, 4, 8, 8
    args = [torch.from_numpy(gen.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, di), (b, s, di), (b, s, n), (b, s, n),
                          (di, n), (di,), (b, di, n))]
    before = ssm_scan.LAUNCHES
    with pytest.raises(ValueError, match="cuda"):
        ssm_scan.launch(*args, 1)
    y, h = ssm_scan.ssm_scan(*args)
    wy, wh = ssm_scan.ssm_scan_plain(*args)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert ssm_scan.LAUNCHES == before


def test_source_matches_the_plan():
    """The kernel's block size, its C signature (one more int, the lane
    count) and its instantiations are the ones the plan assumes."""
    threads = re.search(r"constexpr int SCAN_THREADS = (\d+);", SOURCE)
    assert int(threads.group(1)) == ssm_scan.THREADS
    for index in ("const int ch0 = blockIdx.x * CH;",
                  "const int cl = threadIdx.x / L;",
                  "const int lane = threadIdx.x % L;",
                  "const int ch = ch0 + cl;", "const bool live = ch < DI;",
                  "* N + lane * SL;",
                  "const dim3 grid((DI + Sh::CH - 1) / Sh::CH, B);"):
        assert index in SOURCE, index
    sig = re.search(r'extern "C" int ssm_scan_f32\(([^)]*)\)', SOURCE)
    params = [p.split()[-1] for p in sig.group(1).split(",")]
    assert params[-6:] == ["B", "S", "DI", "N", "lanes", "stream"]
    types = ssm_scan._SIGNATURES["ssm_scan_f32"]
    assert len(types) == len(params) == 16
    assert params[9] == "ckpt"
    assert types[10:15] == [types[10]] * 5 and types[10] is not types[0]
    cases = re.search(r"int dispatch\(.*?\n}\n", SOURCE, re.S).group(0)
    assert sorted(int(c) for c in re.findall(r"case (\d+):", cases)) == [
        1, 2, 4, 8]
    assert "if constexpr (N / 8 >= 2)" in cases
    assert ssm_scan.lane_counts(8) == (1, 2, 4)
    assert ssm_scan.lane_counts(16) == (1, 2, 4, 8)
