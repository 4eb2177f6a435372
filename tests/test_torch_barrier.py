"""Port parity: barrier schedules and padded level tables.

Every ``LevelTable`` field of the port must equal the JAX package's in
value and dtype (int32 group sizes and bank ids, float32 everything
else) for the central counter, every uniform radix, the 256-PE partial
trees and the hardware event unit at N in {64, 256, 1024}.
"""
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro_torch.core import barrier

NS = (64, 256, 1024)


def _schedules(mod, n):
    """Central, every k-ary tree and the event unit over ``n`` PEs, plus
    the partial trees over one 256-PE FFT subset at ``n == 256``."""
    out = [mod.central_counter(n)]
    out += [mod.kary_tree(k, n_pes=n) for k in mod.all_radices(n)]
    out += [mod.hw_event_unit(n)]
    if n == 256:
        out += [mod.partial_barrier(256, k) for k in mod.all_radices(256)]
    return out


def _assert_tables_equal(jtab, ttab):
    for f in jbarrier.LevelTable._fields:
        want = np.asarray(getattr(jtab, f))
        got = getattr(ttab, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        assert np.array_equal(got, want), f


@pytest.mark.parametrize("n", NS)
def test_level_tables_bit_exact(n):
    for js, ts in zip(_schedules(jbarrier, n), _schedules(barrier, n)):
        _assert_tables_equal(jbarrier.level_table(js),
                             barrier.level_table(ts, device="cpu"))


@pytest.mark.parametrize("n", NS)
def test_stacked_tables_and_widths_bit_exact(n):
    jscheds = [s for s in _schedules(jbarrier, n) if s.n_pes == n]
    tscheds = [s for s in _schedules(barrier, n) if s.n_pes == n]
    jtab = jbarrier.stack_tables(jscheds)
    ttab = barrier.stack_tables(tscheds, device="cpu")
    _assert_tables_equal(jtab, ttab)
    assert (barrier.telescope_widths(ttab, n)
            == jbarrier.telescope_widths(jtab, n))
    depth = ttab.max_levels
    assert barrier.default_widths(n, depth) == jbarrier.default_widths(
        n, depth)


@pytest.mark.parametrize("n", NS)
def test_schedule_structure_and_names(n):
    for js, ts in zip(_schedules(jbarrier, n), _schedules(barrier, n)):
        assert barrier.schedule_name(ts) == jbarrier.schedule_name(js)
        assert ts.name == js.name
        assert (ts.n_pes, ts.radix, ts.partial, ts.hw) == (
            js.n_pes, js.radix, js.partial, js.hw)
        assert [(l.group_size, l.span, l.latency) for l in ts.levels] == [
            (l.group_size, l.span, l.latency) for l in js.levels]
    assert list(barrier.all_radices(n)) == list(jbarrier.all_radices(n))


@pytest.mark.parametrize("n", NS)
def test_level_table_from_reference_arrays(n):
    """The JAX table, carried across as numpy arrays, is the port's own
    table of the same schedule."""
    for js, ts in zip(_schedules(jbarrier, n), _schedules(barrier, n)):
        arrays = {f: np.asarray(v)
                  for f, v in jbarrier.level_table(js)._asdict().items()}
        carried = barrier.level_table_from_arrays(arrays, device="cpu")
        own = barrier.level_table(ts, device="cpu")
        for f in barrier.LevelTable._fields:
            assert torch.equal(getattr(carried, f), getattr(own, f)), f


def test_level_tables_take_and_check_placements():
    """No placement path is left unported: both table constructors take
    counter placements (tests/test_torch_placement.py holds them to the
    reference) and reject placements that do not fit the schedule."""
    from repro_torch.core import placement
    sched = barrier.kary_tree(32)
    other = placement.place_counters(barrier.kary_tree(4), "central")
    with pytest.raises(ValueError, match="placement maps"):
        barrier.level_table(sched, placement=other, device="cpu")
    with pytest.raises(ValueError, match="placements"):
        barrier.stack_tables([sched], placements=[None, None], device="cpu")
    placed = barrier.stack_tables(
        [sched], placements=[placement.place_counters(sched, "central")],
        device="cpu")
    assert int(placed.bank_ids[0, 0, :32].max()) == 0


def test_interior_padding_rejected():
    table = barrier.level_table(barrier.kary_tree(4, n_pes=64),
                                device="cpu")
    sizes = table.group_sizes.clone()
    sizes[0] = 1        # identity padding before a real level
    with pytest.raises(ValueError, match="tail-padded only"):
        barrier.validate_tail_padding(table._replace(group_sizes=sizes))


def test_invalid_schedules_rejected_like_reference():
    for bad in (lambda m: m.kary_tree(3), lambda m: m.kary_tree(2048),
                lambda m: m.mixed_radix_tree((4, 1)),
                lambda m: m.partial_barrier(2048, 2)):
        with pytest.raises(ValueError):
            bad(jbarrier)
        with pytest.raises(ValueError):
            bad(barrier)
