"""The ``serving`` section of ``src/repro_torch/reference_values.json``:
what the JAX package's tuning server answers at full width (N = 1024,
the default ``TeraPoolConfig``, hierarchy-pruned compositions, 8 trials
a kernel request), and the closed-form fallback's picks there.

Six kernel requests, ``dotp_1Mi``, ``fiveg_fft_stage`` and
``straggler_pareto`` (whose Pareto tail is the ``powf`` kernel on the
card) each under ``cycles`` and ``pareto``, are submitted before the
worker starts, so they coalesce into one dispatch.  The section holds
each response's tier, provenance, batch size, winner, mean span and
mean energy, the digest of each kernel's arrival draw, and
``fallback_uniform``'s pick per objective.  ``chip_smoke.py``'s
``serving`` phase holds the card to it.

    PYTHONPATH=src python tests/test_torch_serving_values.py

rewrites the section with the JAX package (~30 s on the CPU).
"""
import json
import sys
from pathlib import Path

import numpy as np

from repro.core import topology as jtopology
from repro.runtime import serving as jserving
from repro_torch.core import topology
from repro_torch.runtime import serving
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
KERNELS = ("dotp_1Mi", "fiveg_fft_stage", "straggler_pareto")
OBJECTIVES = ("cycles", "pareto")
FALLBACK_OBJECTIVES = ("cycles", "energy", "edp", "pareto")
BATCH_WINDOW = 0.005


def section(module, topo, **server_kw) -> dict:
    """The section as ``module``'s server (either package's
    ``runtime.serving``) computes it."""
    cfg = topo.DEFAULT
    srv = module.TuningServer(
        module.ServerConfig(batch_window=BATCH_WINDOW), start=False,
        **server_kw)
    tickets = [(k, o, srv.submit(module.TuneRequest(kernel=k, objective=o)))
               for k in KERNELS for o in OBJECTIVES]
    digests = {p.label: module._trace_digest(p.arrivals)
               for p in srv._queue}
    srv.start()
    requests = []
    for kernel, objective, ticket in tickets:
        r = ticket.result(timeout=3600)
        requests.append({
            "kernel": kernel, "objective": objective,
            "provenance": r.provenance, "tier": r.tier,
            "batch_size": r.batch_size, "name": r.name,
            "mean_span": float(r.mean_span),
            "mean_energy": float(r.mean_energy)})
    srv.close()
    fallback = {}
    for objective in FALLBACK_OBJECTIVES:
        sched, span, energy = module.fallback_uniform(cfg.n_pes, cfg,
                                                      objective)
        fallback[objective] = {"name": module.barrier.schedule_name(sched),
                               "mean_span": span, "mean_energy": energy}
    return {"n_pes": cfg.n_pes, "n_trials": srv.config.default_n_trials,
            "prune": "hierarchy", "batch_window": BATCH_WINDOW,
            "requests": requests, "digests": digests,
            "fallback": fallback}


def _load() -> dict:
    return json.loads(PATH.read_text())


if __name__ == "__main__":
    values = _load()
    values["serving"] = section(jserving, jtopology)
    PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote the serving section of {PATH}")


def test_serving_section_matches_jax():
    """The stored section is what the JAX package's server answers now."""
    assert _load()["serving"] == json.loads(json.dumps(
        section(jserving, jtopology)))


def test_serving_section_matches_port():
    """The port's server on the CPU: one coalesced dispatch of exact
    answers, the winners, mean spans, arrival digests and fallback picks
    equal, the mean energies to rtol 1e-6 (torch and XLA sum in other
    orders, ROADMAP queue 3)."""
    want = _load()["serving"]
    got = section(serving, topology, device="cpu")
    assert got["digests"] == want["digests"]
    assert got["fallback"] == want["fallback"]
    for g, w in zip(got["requests"], want["requests"], strict=True):
        energy = g.pop("mean_energy")
        np.testing.assert_allclose(energy, w["mean_energy"], rtol=1e-6)
        assert g == {k: v for k, v in w.items() if k != "mean_energy"}
        assert (g["provenance"], g["tier"], g["batch_size"]) == (
            "batched", "exact", len(KERNELS) * len(OBJECTIVES))
