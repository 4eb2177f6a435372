"""The fault-tolerant runtime (port of ``repro.runtime``): the
fault-tolerant step runner (:mod:`~repro_torch.runtime.fault`), the
elastic re-meshing arithmetic (:mod:`~repro_torch.runtime.elastic`),
deterministic fault injection (:mod:`~repro_torch.runtime.inject`), the
persistent schedule cache (:mod:`~repro_torch.runtime.schedule_cache`),
the resilient sweeps (:mod:`~repro_torch.runtime.resilient_sweep`) and
the request-serving daemon (:mod:`~repro_torch.runtime.serving`)."""
from . import elastic, inject, schedule_cache, serving
from .fault import (FaultConfig, FaultTolerantRunner, StepStats,
                    StragglerAbort, backoff_delay, supervise)
from .inject import (DeviceLoss, FaultPlan, Preemption, SimulatedFault,
                     SimulatedOOM)
from .resilient_sweep import (ResilienceConfig, SweepReport,
                              resilient_sweep_arrivals,
                              resilient_sweep_schedules,
                              resilient_sweep_workloads,
                              resilient_tune_barrier)
from .serving import (ServerClosed, ServerConfig, ServerOverloaded,
                      ServerStats, TuneRequest, TuneResponse,
                      TuningServer)

__all__ = ["DeviceLoss", "FaultConfig", "FaultPlan",
           "FaultTolerantRunner", "Preemption", "ResilienceConfig",
           "ServerClosed", "ServerConfig", "ServerOverloaded",
           "ServerStats", "SimulatedFault", "SimulatedOOM", "StepStats",
           "StragglerAbort", "SweepReport", "TuneRequest",
           "TuneResponse", "TuningServer", "backoff_delay", "elastic",
           "inject", "resilient_sweep_arrivals",
           "resilient_sweep_schedules", "resilient_sweep_workloads",
           "resilient_tune_barrier", "schedule_cache", "serving",
           "supervise"]
