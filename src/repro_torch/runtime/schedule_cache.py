"""Persistent, checksummed on-disk schedule cache (port of
``repro.runtime.schedule_cache``).

The tuner's in-process stores (``functools.lru_cache`` on
:func:`repro_torch.core.tuning.tuned_for_workload` and the 5G mode
caches in :mod:`repro_torch.core.fiveg`) die with the process — a
serving deployment re-runs the full composition x placement sweep for
every worker restart.  This module promotes those stores to a shared on-disk layer:

* **Keyed on (kind, params, n_pes, cfg, code-version)** — the code
  version is a digest of the simulator/tuner sources, so a cache
  written by an older physics model is silently invalidated instead of
  served (a tuned schedule is only as good as the simulator that
  picked it).
* **Atomic** — entries are published with the same tmp + ``os.replace``
  pattern as checkpoints; concurrent writers race benignly (last
  writer wins with a complete file, readers never see a torn entry).
* **Checksummed** — every entry embeds a SHA-256 over its payload; a
  corrupt or truncated entry is detected, dropped and recomputed,
  never trusted.

The cache activates when ``REPRO_SCHEDULE_CACHE`` names a directory;
unset, every consumer falls back to its in-memory store only (tests
stay hermetic).  Payloads hold *encoded* schedules/placements —
:func:`encode_schedule` round-trips any
:class:`~repro_torch.core.barrier.BarrierSchedule` through its level sizes
(the schedule algebra re-derives spans and latencies from ``cfg``),
and placements through their explicit bank/latency tables.

The store is additionally BOUNDED: ``REPRO_SCHEDULE_CACHE_TTL``
(seconds) expires entries by age and ``REPRO_SCHEDULE_CACHE_MAX``
(entry count) applies LRU eviction on store — both mtime-based (a hit
touches its entry's mtime, so recently served schedules survive the
cap), both off when unset, both counted in ``STATS["evictions"]``.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

# Environment knob naming the cache directory; unset == disabled.
CACHE_ENV = "REPRO_SCHEDULE_CACHE"
# Entry time-to-live in seconds (float); unset/empty == entries never
# expire.  Age is measured from the entry file's mtime, which doubles
# as the LRU clock (hits re-touch it).
TTL_ENV = "REPRO_SCHEDULE_CACHE_TTL"
# Maximum entry count (int); unset/empty == unbounded.  Enforced on
# every ``store`` by evicting least-recently-used entries first.
MAX_ENV = "REPRO_SCHEDULE_CACHE_MAX"

# Process-level cache traffic counters (reset with ``reset_stats``).
# ``races`` counts tolerated ``FileNotFoundError`` windows — an entry
# (or the whole cache root) vanishing between our check and our use,
# e.g. a concurrent ``evict`` in another process.  A race is a benign
# miss, never a corruption and never a crash.
STATS = {"hits": 0, "misses": 0, "corrupt": 0, "stores": 0,
         "evictions": 0, "races": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def cache_dir() -> Optional[Path]:
    """The active cache directory, or ``None`` when caching is off.
    Read per call so tests (and operators) can flip the env var."""
    d = os.environ.get(CACHE_ENV)
    return Path(d) if d else None


def _env_number(name: str, cast) -> Optional[float]:
    """The env knob as a number, or ``None`` when unset/empty/invalid
    (a malformed limit must never take the cache down)."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        val = cast(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def _expired(path: Path, now: float) -> bool:
    """Entry older than the TTL (``False`` when no TTL is set)."""
    ttl = _env_number(TTL_ENV, float)
    if ttl is None:
        return False
    try:
        return now - path.stat().st_mtime > ttl
    except FileNotFoundError:
        raise                        # vanished concurrently: caller's race
    except OSError:
        return True


def evict(now: Optional[float] = None) -> int:
    """Apply the TTL and LRU-size policies to the store: drop expired
    entries, then the least-recently-used entries beyond the
    ``REPRO_SCHEDULE_CACHE_MAX`` cap (mtime is the LRU clock — hits
    touch it).  Returns the number of entries evicted; called on every
    :func:`store`, callable directly by operators."""
    root = cache_dir()
    if root is None or not root.is_dir():
        return 0
    now = time.time() if now is None else now
    entries = []
    dropped = 0
    for path in root.glob("*.json"):
        try:
            expired = _expired(path, now)
        except FileNotFoundError:
            STATS["races"] += 1      # another process beat us to it
            continue
        if expired:
            try:
                path.unlink()
                dropped += 1
            except OSError:
                pass
            continue
        try:
            entries.append((path.stat().st_mtime, path))
        except OSError:
            pass
    cap = _env_number(MAX_ENV, int)
    if cap is not None and len(entries) > cap:
        entries.sort()               # oldest mtime first == LRU first
        for _, path in entries[:len(entries) - int(cap)]:
            try:
                path.unlink()
                dropped += 1
            except OSError:
                pass
    STATS["evictions"] += dropped
    return dropped


@functools.lru_cache(maxsize=1)
def code_version() -> str:
    """Digest of every source file of this package that the tuned result
    depends on: the simulator cores, the schedule/placement algebra, the
    sweep engine, the tuner, the workload models and the random stream
    they draw from.  Any edit to the physics invalidates every cached
    schedule (and the port never serves an entry the reference wrote)."""
    from ..core import (barrier, barrier_sim, energy, placement, prng,
                        sweep, topology, tuning, workloads, xla_math)
    h = hashlib.sha256()
    for mod in (barrier, barrier_sim, energy, placement, prng, sweep,
                topology, tuning, workloads, xla_math):
        h.update(Path(mod.__file__).read_bytes())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _key_repr(key: tuple) -> str:
    return repr(tuple(key) + ("code", code_version()))


def _entry_path(root: Path, key: tuple) -> Path:
    digest = hashlib.sha256(_key_repr(key).encode()).hexdigest()[:32]
    return root / f"{digest}.json"


def _payload_checksum(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def load(key: tuple) -> Optional[dict]:
    """The cached payload for ``key``, or ``None`` on miss.  Corrupt
    entries (unparseable, checksum mismatch, digest collision) count in
    ``STATS["corrupt"]``, are unlinked, and read as a miss."""
    root = cache_dir()
    if root is None:
        return None
    path = _entry_path(root, key)
    if not path.exists():
        STATS["misses"] += 1
        return None
    try:
        expired = _expired(path, time.time())
    except FileNotFoundError:
        # Evicted/unlinked between the exists() check and the stat():
        # a plain miss, not a corruption.
        STATS["races"] += 1
        STATS["misses"] += 1
        return None
    if expired:
        try:
            path.unlink()
        except OSError:
            pass
        STATS["evictions"] += 1
        STATS["misses"] += 1
        return None
    try:
        entry = json.loads(path.read_text())
        payload = entry["payload"]
        if entry["sha256"] != _payload_checksum(payload):
            raise ValueError("payload checksum mismatch")
        if entry["key"] != _key_repr(key):
            raise ValueError("key mismatch (digest collision?)")
    except FileNotFoundError:
        STATS["races"] += 1          # vanished between stat and read
        STATS["misses"] += 1
        return None
    except (OSError, json.JSONDecodeError, KeyError, TypeError,
            ValueError, UnicodeDecodeError):
        STATS["corrupt"] += 1
        try:
            path.unlink()
        except OSError:
            pass
        return None
    STATS["hits"] += 1
    try:
        os.utime(path)               # LRU touch: a hit is recent use
    except OSError:
        pass
    return payload


def store(key: tuple, payload: dict) -> None:
    """Atomically publish ``payload`` under ``key`` (no-op when the
    cache is disabled).

    Tolerates the cache root vanishing mid-publish (a concurrent
    teardown or operator ``rm -rf``): the publish is retried once after
    re-creating the root, then given up silently — a lost cache entry
    must never take the tuner down."""
    root = cache_dir()
    if root is None:
        return
    entry = {"key": _key_repr(key),
             "sha256": _payload_checksum(payload),
             "payload": payload}
    blob = json.dumps(entry, indent=1)
    for attempt in range(2):
        root.mkdir(parents=True, exist_ok=True)
        try:
            fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        except FileNotFoundError:
            STATS["races"] += 1
            continue
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, _entry_path(root, key))
        except FileNotFoundError:
            STATS["races"] += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        STATS["stores"] += 1
        evict()
        return


# ---------------------------------------------------------------------------
# Schedule / placement codecs.
# ---------------------------------------------------------------------------

def encode_schedule(schedule) -> dict:
    """JSON form of a schedule: its level sizes + partial flag (spans
    and latencies are re-derived from ``cfg`` on decode, so the codec
    round-trips every constructor — kary/central/partial/mixed), plus
    the ``hw`` event-unit flag (hw schedules re-derive their stage
    structure from ``cfg`` too)."""
    out = {"sizes": list(schedule.sizes), "partial": bool(schedule.partial)}
    if getattr(schedule, "hw", False):
        out["hw"] = True
        out["n_pes"] = int(schedule.n_pes)
    return out


def decode_schedule(payload: dict, cfg):
    from ..core import barrier
    if payload.get("hw"):
        return barrier.hw_event_unit(int(payload["n_pes"]), cfg=cfg)
    return barrier.mixed_radix_tree(tuple(int(s) for s in payload["sizes"]),
                                    cfg=cfg, partial=bool(payload["partial"]))


def encode_placement(placement) -> Optional[dict]:
    if placement is None:
        return None
    return {"strategy": placement.strategy,
            "banks": [list(row) for row in placement.banks],
            "latencies": [list(row) for row in placement.latencies]}


def decode_placement(payload: Optional[dict]):
    if payload is None:
        return None
    from ..core.placement import CounterPlacement
    return CounterPlacement(
        strategy=str(payload["strategy"]),
        banks=tuple(tuple(int(b) for b in row)
                    for row in payload["banks"]),
        latencies=tuple(tuple(int(x) for x in row)
                        for row in payload["latencies"]))


def encode_pair(schedule, placement, objective: str = "cycles") -> dict:
    """Encoded (schedule, placement) pair; ``objective`` records WHICH
    metric picked this winner ("cycles", "energy", "edp" or "pareto"),
    so operators can tell a latency-tuned entry from an energy-tuned
    one when auditing the store."""
    return {"schedule": encode_schedule(schedule),
            "placement": encode_placement(placement),
            "objective": str(objective)}


def decode_pair(payload: dict, cfg) -> Tuple:
    """Decode :func:`encode_pair` (tolerant of pre-energy entries that
    lack the ``objective`` field)."""
    return (decode_schedule(payload["schedule"], cfg),
            decode_placement(payload["placement"]))


def pair_objective(payload: dict) -> str:
    """The objective recorded in an encoded pair ("cycles" for legacy
    entries written before the energy subsystem)."""
    return str(payload.get("objective", "cycles"))
