"""Elastic re-meshing arithmetic (port of ``repro.runtime.elastic``).

At thousand-node scale, node loss is routine.  The helpers here pick
the largest usable set of surviving devices: a (data, model) grid for
training, a prefix of devices that divides a sweep's schedule axis, or
a (schedule x kernel) prefix for an arrival grid.  They are arithmetic
over device lists (``torch.device`` objects or anything else), so they
run anywhere.  Building the mesh itself (:func:`make_elastic_mesh`)
needs the port's multi-device slice, which is still to come.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple


def viable_mesh_shape(n_devices: int, *, model_parallel: int,
                      min_data: int = 1) -> Optional[Tuple[int, int]]:
    """Largest (data, model) grid that fits ``n_devices`` while keeping
    the TP degree fixed (weights must still fit per device)."""
    if n_devices < model_parallel * min_data:
        return None
    data = n_devices // model_parallel
    # power-of-two data axis keeps batch divisibility simple
    data = 1 << int(math.log2(data))
    return (data, model_parallel)


def make_elastic_mesh(*, model_parallel: int,
                      devices: Optional[Sequence] = None):
    """The biggest healthy (data, model) device mesh: not ported yet.  It
    needs ``torch.distributed`` device meshes, ROADMAP queue 1 item 5
    (collectives and multi-device); until then it raises."""
    raise NotImplementedError(
        "make_elastic_mesh needs the port's device meshes (ROADMAP queue 1 "
        "item 5, collectives and multi-device); viable_mesh_shape gives "
        "the shape")


def viable_schedule_devices(devices: Sequence, n_schedules: int, *,
                            min_devices: int = 1) -> Optional[tuple]:
    """Largest prefix of ``devices`` whose size divides the schedule
    axis, the 1-D sibling of :func:`viable_mesh_shape` for the barrier
    sweeps, whose only sharded axis is the schedule stack.

    After a device loss the resilient sweep runtime
    (:mod:`repro_torch.runtime.resilient_sweep`) calls this with the
    survivors.  Returns ``None`` when fewer than ``min_devices`` devices
    remain viable (no survivor at all is never viable)."""
    if n_schedules < 1:
        raise ValueError(f"need a non-empty schedule axis, got "
                         f"{n_schedules}")
    for d in range(len(devices), min_devices - 1, -1):
        if d >= 1 and n_schedules % d == 0:
            return tuple(devices[:d])
    return None


def _mesh_shape(n_devices: int, n_sched: int, n_kern: int) -> tuple:
    """The (sched, kern) mesh shape of a 2-D arrival grid, as the
    reference's sweep dispatcher picks it: ``ds`` divides the schedule
    axis, ``dk`` the kernel axis, ``ds * dk <= n_devices``, maximizing
    the devices used and preferring the schedule axis on ties."""
    best = (1, 1, 1)                       # (used, ds, dk)
    for ds in range(1, min(n_devices, n_sched) + 1):
        if n_sched % ds:
            continue
        for dk in range(1, n_devices // ds + 1):
            if n_kern % dk:
                continue
            best = max(best, (ds * dk, ds, dk))
    return best[1], best[2]


def viable_grid_devices(devices: Sequence, n_schedules: int,
                        n_kernels: int, *,
                        min_devices: int = 1) -> Optional[tuple]:
    """Largest usable prefix of ``devices`` for a 2-D (schedule x
    kernel) arrival grid, the 2-D sibling of
    :func:`viable_schedule_devices`: the ``ds * dk``-device prefix of the
    :func:`_mesh_shape` a fresh launch would pick, or ``None`` when fewer
    than ``min_devices`` remain viable."""
    if n_schedules < 1:
        raise ValueError(f"need a non-empty schedule axis, got "
                         f"{n_schedules}")
    if n_kernels < 1:
        raise ValueError(f"need a non-empty kernel axis, got {n_kernels}")
    if not devices:
        return None
    ds, dk = _mesh_shape(len(devices), n_schedules, n_kernels)
    if ds * dk < max(1, min_devices):
        return None
    return tuple(devices[:ds * dk])


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-device batch constant across a re-mesh (synchronous DP
    semantics: the optimizer sees a smaller global batch until capacity
    returns; lr rescaling is the caller's policy)."""
    per_device = global_batch // old_data
    return per_device * new_data
