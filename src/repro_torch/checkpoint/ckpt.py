"""Atomic checkpointing (port of ``repro.checkpoint.ckpt``).

Layout, the reference's: one directory per step, ``step_<8 digits>``,
holding one ``.npz`` per host (``host_<4 digits>.npz``) with that
host's leaves and a JSON manifest (``step``, ``host_count``, the sorted
leaf ``keys``, ``time``, ``extra``).  Writes are crash-safe: everything
lands in ``<dir>.tmp`` and one atomic rename publishes the step;
``latest_step`` only believes directories whose manifest is complete.

A tree is a nested structure of dicts, NamedTuples, tuples and lists
whose leaves are tensors, numpy arrays or Python scalars (the port's
stand-in for a pytree).  A leaf's key is its path joined by ``/``: dict
keys, NamedTuple field names and sequence indices, as the reference
names the leaves of the same structure, so either package restores what
the other saved.  bfloat16 leaves are stored as float32 (``.npz`` has no
bfloat16) and restored to the template's dtype, exactly.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list]:
    """``(name, child)`` pairs of an inner node, ``None`` for a leaf.
    Dict keys come sorted, as the reference flattens them."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for name, child in kids:
        flat.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return flat


def _unflatten(template, values: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix
                              else str(k)) for k, v in template.items()}
    kids = _children(template)
    if kids is None:
        return values[prefix]
    rebuilt = [_unflatten(c, values, f"{prefix}/{n}" if prefix else n)
               for n, c in kids]
    if _is_namedtuple(template):
        return type(template)(*rebuilt)
    return type(template)(rebuilt)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:    # npz can't round-trip bfloat16
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def _like(template_leaf, stored: np.ndarray):
    """``stored`` in the template leaf's type, dtype and device."""
    if isinstance(template_leaf, torch.Tensor):
        return torch.from_numpy(np.array(stored)).to(
            dtype=template_leaf.dtype, device=template_leaf.device)
    if isinstance(template_leaf, np.ndarray):
        return np.asarray(stored).astype(template_leaf.dtype)
    return stored


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         host_id: int = 0, host_count: int = 1,
         extra: Optional[Dict[str, Any]] = None) -> Path:
    """Atomically save ``tree`` for this host.  Multi-host: every host
    calls save; host 0 publishes the rename once all host files exist."""
    root = Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)

    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(tmp / f"host_{host_id:04d}.npz", **arrays)

    if host_id == 0:
        manifest = {"step": step, "host_count": host_count,
                    "keys": sorted(arrays.keys()),
                    "time": time.time(), "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))

    # Publish when every host file is present (single-process runs reach
    # this immediately).
    ready = all((tmp / f"host_{h:04d}.npz").exists()
                for h in range(host_count))
    if ready and (tmp / "manifest.json").exists():
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final
    return tmp


def _manifest_ok(step_dir: Path) -> bool:
    """A checkpoint directory counts only if its manifest parses and
    names a step: a crash between file creation and write (or a torn
    write) makes the directory invisible to resume, not fatal."""
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return False
    return isinstance(manifest, dict) and "step" in manifest


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest complete step under ``ckpt_dir``, or ``None``."""
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and not d.name.endswith(".tmp") \
                and _manifest_ok(d):
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, template: Any, *,
            step: Optional[int] = None, host_id: int = 0
            ) -> Tuple[Any, Dict[str, Any]]:
    """Restore this host's leaves into the structure of ``template``
    (each tensor leaf in its template's dtype and device); returns
    ``(tree, manifest)``."""
    root = Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_t = _flatten(template)
    with np.load(d / f"host_{host_id:04d}.npz") as data:
        missing = set(flat_t) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}")
        values = {k: _like(leaf, data[k]) for k, leaf in flat_t.items()}
    return _unflatten(template, values), manifest


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    """Keep the newest ``keep`` complete checkpoints (and drop stale
    .tmp dirs older than an hour)."""
    root = Path(ckpt_dir)
    if not root.exists():
        return
    done = sorted(d for d in root.iterdir()
                  if d.is_dir() and d.name.startswith("step_")
                  and not d.name.endswith(".tmp"))
    for d in done[:-keep] if keep else done:
        shutil.rmtree(d)
    cutoff = time.time() - 3600
    for d in root.glob("*.tmp"):
        if d.stat().st_mtime < cutoff:
            shutil.rmtree(d)
