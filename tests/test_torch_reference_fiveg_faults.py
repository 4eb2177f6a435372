"""The 5G degradation curve of ``benchmarks/bench_faults.py`` against the
stored ``fiveg_faults`` section, in JAX and in the port.

A JAX recompute of ``src/repro_torch/reference_values.json`` (the
helpers and the stored file are ``tests/test_torch_reference_values.py``'s),
in a file of its own: pytest-xdist's ``--dist loadfile`` runs a file on
one worker, and this test alone runs minutes on the CPU."""
import numpy as np

from repro_torch.examples import bench_faults

from test_torch_reference_values import FAULTS, _fiveg_faults, _load
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_fiveg_faults_match_jax_and_port():
    """The stored 5G degradation curve: one mode recomputed with JAX,
    and every mode reproduced by the port's CPU run of the example
    driver (cycles, completion and watchdog counts bit for bit)."""
    ref = _load()["fiveg_faults"]
    assert _fiveg_faults(modes=("hw",))["hw"] == ref["hw"]
    _, curve = bench_faults.fiveg_degradation(device="cpu")
    for mode in FAULTS.FIVEG_MODES:
        for res, want in zip(curve[mode], ref[mode]):
            for c in ("total_cycles", "completion_rate", "timed_out_levels"):
                assert getattr(res, c).item() == np.float32(want[c]), \
                    (mode, c)
            for c in ("sync_fraction", "sync_energy"):
                np.testing.assert_allclose(getattr(res, c).item(), want[c],
                                           rtol=1e-5, err_msg=c)
