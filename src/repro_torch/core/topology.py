"""TeraPool machine model.

The paper's cluster: 1024 Snitch RISC-V PEs tightly coupled to a 4 MiB
multi-banked shared L1.  Hierarchy: 8 PEs / Tile, 16 Tiles / Group,
8 Groups / cluster; banking factor 4 (4096 banks).  Access latency to any
bank is bounded: 1 cycle within the Tile, <3 cycles within the Group,
<5 cycles across Groups.  Banks are single-ported: concurrent atomics to
the same bank serialize at 1 op/cycle.

All timing constants live in :class:`TeraPoolConfig` so the simulator can
be re-calibrated; the defaults reproduce the paper's headline numbers
(see tests/test_barrier_sim.py and EXPERIMENTS.md §Repro).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TeraPoolConfig:
    """Timing/topology model of the TeraPool cluster."""

    n_pes: int = 1024
    pes_per_tile: int = 8
    tiles_per_group: int = 16
    n_groups: int = 8
    banking_factor: int = 4

    # Memory access latency (cycles) by locality class.
    lat_tile: int = 1     # PE -> bank in the same Tile
    lat_group: int = 3    # PE -> bank in the same Group
    lat_cluster: int = 5  # PE -> bank in another Group

    # Single-ported banks: one atomic serviced per cycle.
    bank_service_cycles: int = 1

    # Software overhead of one barrier level: address computation, the
    # amo.add issue slot, the compare/branch on the fetched value and the
    # counter-reset store of the last arriver (re-initialization is folded
    # into the arrival phase, Sec. 3).
    instr_per_level: int = 20

    # Notification phase: write to the memory-mapped wakeup register
    # (AXI, cluster-level latency), wakeup-unit trigger fan-out, and the
    # WFI resume cost of a sleeping Snitch core.
    wakeup_write: int = 5
    wakeup_trigger: int = 2
    wfi_resume: int = 8

    # Hardware event unit (Glaser et al., arXiv 2004.06662: a dedicated
    # synchronization/event unit next to the cores).  A PE signals its
    # arrival with one store to the unit's trigger register
    # (``hw_entry_instr`` cycles of software); the unit's combinational
    # aggregation tree then resolves each stage in ``hw_level_cycles``
    # — no shared-counter atomics, no per-level software path.
    hw_entry_instr: int = 2
    hw_level_cycles: int = 1

    @property
    def pes_per_group(self) -> int:
        return self.pes_per_tile * self.tiles_per_group  # 128

    @property
    def n_banks(self) -> int:
        return self.n_pes * self.banking_factor

    @property
    def banks_per_tile(self) -> int:
        return self.pes_per_tile * self.banking_factor   # 32

    @property
    def banks_per_group(self) -> int:
        return self.pes_per_group * self.banking_factor  # 512

    @property
    def wakeup_cycles(self) -> int:
        """Full notification cost: register write -> trigger -> resume."""
        return self.wakeup_write + self.wakeup_trigger + self.wfi_resume

    def access_latency(self, span: int) -> int:
        """Legacy span heuristic: latency for a PE to reach a counter
        placed local to a *contiguous* block of ``span`` PEs (the paper
        places leaf counters on contiguous PE indices, Sec. 5).

        .. deprecated::
            Counter latency is now derived from an explicit counter ->
            bank mapping (:mod:`repro.core.placement`), which models
            *where* a counter lives instead of assuming it sits inside
            its span.  This method is retained as the documented
            fallback used when no :class:`~repro.core.placement.
            CounterPlacement` is given; the paper-style ``leaf_local``
            strategy reproduces it bit-for-bit
            (tests/test_placement.py).
        """
        if span <= self.pes_per_tile:
            return self.lat_tile
        if span <= self.pes_per_group:
            return self.lat_group
        return self.lat_cluster

    def span_bank_latency(self, pe_lo: int, span: int, bank: int) -> int:
        """Worst-accessor latency for the contiguous PE block
        ``[pe_lo, pe_lo + span)`` to reach ``bank``.

        The locality class is decided by the *farthest* accessing PE —
        consistent with the span heuristic, which charges a whole level
        the class of its span.  A bank inside the accessors' common
        Tile costs ``lat_tile``; inside their common Group,
        ``lat_group``; anything else is a cluster-class access.
        """
        pe_hi = pe_lo + span - 1
        if (pe_lo // self.pes_per_tile == pe_hi // self.pes_per_tile
                == bank // self.banks_per_tile):
            return self.lat_tile
        if (pe_lo // self.pes_per_group == pe_hi // self.pes_per_group
                == bank // self.banks_per_group):
            return self.lat_group
        return self.lat_cluster

    def pe_bank_latency(self, pe: int, bank: int) -> int:
        """Latency for one PE to reach one bank (locality-class model)."""
        return self.span_bank_latency(pe, 1, bank)

    def hw_stage_latency(self, span: int) -> int:
        """Cycles one aggregation stage of the hardware event unit takes
        to resolve once its last input signal is present.  Inside a
        cluster every stage is combinational (``hw_level_cycles``)
        regardless of span — the unit sits next to the cores, signals
        are dedicated wires, not L1 accesses."""
        return self.hw_level_cycles


@dataclasses.dataclass(frozen=True)
class MultiClusterConfig(TeraPoolConfig):
    """TeraPool-of-TeraPools: ``n_clusters`` TeraPool clusters behind an
    inter-cluster interconnect (the scale-out direction of Riedel et
    al., arXiv 2507.05012, and the MemPool line).

    ``n_pes`` is the TOTAL PE count across all clusters; PEs and banks
    keep global contiguous indices, so cluster ``c`` owns PEs
    ``[c * pes_per_cluster, (c+1) * pes_per_cluster)`` and the matching
    bank block.  Inside one cluster the Tile/Group locality classes of
    :class:`TeraPoolConfig` apply unchanged (the per-cluster structure
    may be asymmetric or non-power-of-two, e.g. a 768-PE cluster with
    12 Tiles per Group); any access that crosses a cluster boundary —
    the farthest accessor of a counter, or the counter's bank, living
    in a different cluster — pays the flat remote tier ``lat_remote``
    (AXI hop + remote L1 arbitration, ~5x the intra-cluster worst
    case)."""

    n_clusters: int = 4
    lat_remote: int = 25  # PE -> bank in another cluster

    def __post_init__(self):
        if self.n_clusters < 1:
            raise ValueError(f"need >= 1 cluster, got {self.n_clusters}")
        if self.n_pes % self.n_clusters != 0:
            raise ValueError(
                f"{self.n_pes} PEs do not split into {self.n_clusters} "
                f"equal clusters")

    @property
    def pes_per_cluster(self) -> int:
        return self.n_pes // self.n_clusters

    @property
    def banks_per_cluster(self) -> int:
        return self.pes_per_cluster * self.banking_factor

    def access_latency(self, span: int) -> int:
        """Span heuristic with the remote tier on top: a counter whose
        contiguous span crosses a cluster boundary is remote-class."""
        if span > self.pes_per_cluster:
            return self.lat_remote
        return super().access_latency(span)

    def span_bank_latency(self, pe_lo: int, span: int, bank: int) -> int:
        """Worst-accessor latency with inter-cluster placement classes:
        remote whenever the accessor block spans two clusters or the
        bank lives in a different cluster than the accessors."""
        pe_hi = pe_lo + span - 1
        if not (pe_lo // self.pes_per_cluster
                == pe_hi // self.pes_per_cluster
                == bank // self.banks_per_cluster):
            return self.lat_remote
        return super().span_bank_latency(pe_lo, span, bank)

    def hw_stage_latency(self, span: int) -> int:
        """An aggregation stage whose span crosses a cluster boundary
        combines per-cluster event units over the inter-cluster
        interconnect: it pays the remote tier, not a wire delay."""
        if span > self.pes_per_cluster:
            return self.lat_remote
        return super().hw_stage_latency(span)


def multi_cluster(cluster: TeraPoolConfig = None, n_clusters: int = 4,
                  lat_remote: int = 25) -> MultiClusterConfig:
    """``n_clusters`` copies of ``cluster`` (default: the paper's
    1024-PE TeraPool) as one :class:`MultiClusterConfig`: per-cluster
    timing/structure fields carry over, ``n_pes`` becomes the total."""
    cluster = cluster if cluster is not None else DEFAULT
    fields = {f.name: getattr(cluster, f.name)
              for f in dataclasses.fields(TeraPoolConfig)}
    fields["n_pes"] = cluster.n_pes * n_clusters
    return MultiClusterConfig(**fields, n_clusters=n_clusters,
                              lat_remote=lat_remote)


DEFAULT = TeraPoolConfig()
