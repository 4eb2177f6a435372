"""Build and load the CUDA kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/torch_ext/`` at the root of the checkout, then loaded with
:mod:`ctypes`.  A library's file name carries a digest of its source
and flags, so an edited source is rebuilt and an unchanged one is
reused.  :func:`build` compiles several sources at once, one ``nvcc``
process each, all started together.

Nothing is compiled or loaded when this module is imported: the first
launch of a kernel builds it.  Pointers and the stream go to the C
functions as ``ctypes.c_void_p``; each returns the ``cudaError_t`` of
its launch, which :func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> list:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names) -> dict:
    """Build every library of ``names`` that is missing, one ``nvcc``
    process per source, all running at once.  Returns ``{name: path}``.
    Each library is written under a temporary name and renamed into
    place, so a concurrent build never loads a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    try:
        for name, path in paths.items():
            if path.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.Popen(
                    nvcc_command(name, Path(tmp)), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            except OSError as exc:
                os.unlink(tmp)
                raise RuntimeError(
                    f"cannot run nvcc for {name}.cu: {exc}") from exc
            procs[name] = (tmp, proc)
        failures = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu ---\n{log}")
                os.unlink(tmp)
            else:
                os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with ``argtypes`` set from ``signatures`` (function name -> list of
    ctypes types) and every listed function returning ``int``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
