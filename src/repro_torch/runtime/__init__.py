"""The resumable sweep runtime (port of ``repro.runtime``): the
fault-tolerant step runner (:mod:`~repro_torch.runtime.fault`), the
elastic re-meshing arithmetic (:mod:`~repro_torch.runtime.elastic`),
deterministic fault injection (:mod:`~repro_torch.runtime.inject`), the
persistent schedule cache (:mod:`~repro_torch.runtime.schedule_cache`)
and the resilient sweeps (:mod:`~repro_torch.runtime.resilient_sweep`).
The reference's request-serving daemon (``runtime/serving.py``) is not
ported yet."""
from . import elastic, inject, schedule_cache
from .fault import (FaultConfig, FaultTolerantRunner, StepStats,
                    StragglerAbort, backoff_delay, supervise)
from .inject import (DeviceLoss, FaultPlan, Preemption, SimulatedFault,
                     SimulatedOOM)
from .resilient_sweep import (ResilienceConfig, SweepReport,
                              resilient_sweep_arrivals,
                              resilient_sweep_schedules,
                              resilient_sweep_workloads,
                              resilient_tune_barrier)

__all__ = ["DeviceLoss", "FaultConfig", "FaultPlan",
           "FaultTolerantRunner", "Preemption", "ResilienceConfig",
           "SimulatedFault", "SimulatedOOM", "StepStats",
           "StragglerAbort", "SweepReport", "backoff_delay", "elastic",
           "inject", "resilient_sweep_arrivals",
           "resilient_sweep_schedules", "resilient_sweep_workloads",
           "resilient_tune_barrier", "schedule_cache", "supervise"]
