"""The port's 5G degradation curve on the original threefry stream
against ``BENCH_faults.json``.

A JAX recompute of ``src/repro_torch/reference_values.json`` (the
helpers and the stored file are ``tests/test_torch_reference_values.py``'s),
in a file of its own: pytest-xdist's ``--dist loadfile`` runs a file on
one worker, and this test alone runs minutes on the CPU."""
import json

from repro_torch.core import prng
from repro_torch.examples import bench_faults

from test_torch_reference_values import PATH
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_fiveg_faults_original_stream_reproduce_bench_file():
    """The 5G degradation curve on the original stream is
    ``BENCH_faults.json``'s ``fiveg`` section at its rounding, hw
    ``timed_out_levels`` 26 at 1 % and 2 % included."""
    bench = json.loads((PATH.parents[2] / "BENCH_faults.json").read_text())
    with prng.threefry_partitionable(False):
        record, _ = bench_faults.fiveg_degradation(device="cpu")
    assert record == bench["fiveg"]
    assert [r["timed_out_levels"] for r in record["hw"]][2:4] == [26.0, 26.0]
