"""The simulator half of the port: TeraPool topology, barrier schedules
and their padded level tables, the JAX-compatible PRNG, the plain and
degradation-tolerant simulator cores, the PE fault models, the Fig. 4a
sweep, the tuner and the Fig. 7 5G application.

The public names are the reference's (``repro.core``), less those of its
``collectives`` module, which has no port yet: ``collectives``, ``FLAT``,
``HIERARCHICAL``, ``SyncConfig``, ``gather_param``,
``make_factored_mesh``, ``partial_psum``, ``shard_slice``,
``sync_gradient`` and ``tree_psum``.  ``prng`` stands in for
``jax.random``."""
from . import (barrier, barrier_sim, energy, fiveg, placement, prng, sweep,
               topology, tuning, workloads)
from .barrier import (BarrierSchedule, LevelTable, all_radices,
                      central_counter, compose, counter_width, describe,
                      hw_event_unit, kary_tree, level_table,
                      mixed_radix_tree, partial_barrier, schedule_name,
                      stack_tables)
from .energy import DEFAULT_ENERGY, EnergyModel, energy_reference
from .barrier_sim import (BarrierResult, mean_span_cycles, overhead_fraction,
                          simulate, simulate_reference, simulate_table,
                          uniform_arrivals)
from .placement import (STRATEGIES, CounterPlacement, all_placements,
                        derive_latencies, explicit_placement, place_counters,
                        simulate_placed_reference)
from .sweep import (ArrivalSweepResult, SweepResult, best_radix_per_delay,
                    radix_tables, simulate_radices, simulate_schedules,
                    sweep_arrivals, sweep_barrier, sweep_schedules)
from .topology import DEFAULT, TeraPoolConfig
from .tuning import (ParetoPoint, TunedPoint, WorkloadPoint, all_schedules,
                     best_per_delay, best_per_kernel, best_placed_schedule,
                     best_schedule, enumerate_compositions,
                     hierarchy_compositions, multicluster_compositions,
                     multicluster_schedules, pareto_front, pareto_schedules,
                     tune_barrier, tune_for_arrivals, tune_for_workload,
                     tuned_for_workload, sweep_workloads)
from .workloads import ARRIVAL_KERNELS, FIG6_KERNELS, arrival_batch

__all__ = [
    "ARRIVAL_KERNELS", "ArrivalSweepResult", "BarrierResult",
    "BarrierSchedule", "CounterPlacement", "DEFAULT", "DEFAULT_ENERGY",
    "EnergyModel", "FIG6_KERNELS", "LevelTable", "ParetoPoint",
    "STRATEGIES", "SweepResult", "TeraPoolConfig", "TunedPoint",
    "WorkloadPoint",
    "all_placements", "all_radices", "all_schedules", "arrival_batch",
    "barrier", "barrier_sim", "best_per_delay", "best_per_kernel",
    "best_placed_schedule", "best_radix_per_delay",
    "best_schedule", "central_counter", "compose",
    "counter_width", "derive_latencies", "describe", "energy",
    "energy_reference",
    "enumerate_compositions", "explicit_placement", "fiveg",
    "hierarchy_compositions", "hw_event_unit",
    "kary_tree", "level_table", "mean_span_cycles", "mixed_radix_tree",
    "multicluster_compositions", "multicluster_schedules",
    "overhead_fraction", "pareto_front", "pareto_schedules",
    "partial_barrier", "place_counters", "placement", "prng",
    "radix_tables",
    "schedule_name", "simulate", "simulate_placed_reference",
    "simulate_radices", "simulate_schedules", "simulate_reference",
    "simulate_table", "stack_tables", "sweep", "sweep_arrivals",
    "sweep_barrier", "sweep_schedules", "sweep_workloads",
    "topology", "tune_barrier", "tune_for_arrivals",
    "tune_for_workload", "tuned_for_workload", "tuning",
    "uniform_arrivals", "workloads",
]
