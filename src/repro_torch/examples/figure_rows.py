"""What the figure drivers (``fig5``, ``fig6``, ``fig7``,
``fig_placement``, ``fig_tuned_tree``, ``fig_workload_tuned``) share:
the timing of one figure call and their output.

A driver computes rows ``(name, us_per_call, derived, first_us)``: the
reference benchmark's row name and derived value (same rounding), the
steady wall of the call that produced it and the wall of its first call
(``0.0`` for rows derived from another row's call).  :func:`main` prints
them as CSV under the reference's header, with ``first_us`` in place of
its ``compile_us``, and writes ``build/BENCH_torch_<name>.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.timing import wall_us


def measure(fn, device, *, iters: int = 1) -> tuple:
    """``(result, steady_us, first_us)`` of ``fn()`` on ``device``: the
    first call alone, then the mean of ``iters`` calls (no warm-up call
    between: the figure calls are long)."""
    return wall_us(fn, device, iters=iters, warmup=0)


def card(device) -> str:
    """The device the rows were measured on."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def write(name: str, rows: list, device, out: Path | None = None) -> Path:
    """Write ``rows`` and the device to ``out`` (default
    ``build/BENCH_torch_<name>.json``)."""
    out = out or Path("build") / f"BENCH_torch_{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"figure": name, "device": card(device),
         "columns": ["name", "us_per_call", "derived", "first_us"],
         "rows": [list(r) for r in rows]}, indent=1) + "\n")
    return out


def write_record(record: dict, out: Path) -> dict:
    """Write a benchmark driver's record as JSON to ``out``; returns it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2) + "\n")
    return record


def main(name: str, doc: str, run, argv=None) -> list:
    """Parse ``--device``/``--out``, run ``run(device)``, print its rows
    and write them (with the device) to ``--out``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path,
                    default=Path("build") / f"BENCH_torch_{name}.json")
    args = ap.parse_args(argv)
    rows = run(args.device)
    print("name,us_per_call,derived,first_us")
    for row_name, us, derived, first in rows:
        print(f"{row_name},{us:.1f},{derived},{first:.1f}", flush=True)
    write(name, rows, args.device, args.out)
    return rows
