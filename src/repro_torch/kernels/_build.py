"""Build and load the CUDA kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/torch_ext/`` at the root of the checkout, then loaded with
:mod:`ctypes`.  A ``csrc/<name>.c`` (host code only, such as the C
library helper beside the ``powf`` kernel) is compiled the same way by
the host's C compiler.  A library's file name carries a digest of its source
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
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the library's log (see compiler_log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Host helpers: no fast-math and no vectorization, so a call of a C
# library function stays one scalar call.
CC_FLAGS = ("-O1", "-fno-tree-vectorize", "-fno-fast-math", "-shared",
            "-fPIC")

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


def cc_path() -> str:
    """The host's C compiler: ``$CC``, else ``cc``, else ``gcc``."""
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C compiler found (set CC): the host helpers "
                       "are built at first use")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, or ``csrc/<name>.c`` for a host helper."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.c"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` (or ``.c``) is built.  The
    digest covers the source, the flags and, for a ``.cu`` source, every
    ``csrc/*.cuh`` header it may include."""
    src = source_path(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else CC_FLAGS
    text = src.read_bytes() + " ".join(flags).encode()
    if src.suffix == ".cu":
        text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> list:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def compile_command(name: str, out: Path) -> list:
    """The command that builds ``name``: ``nvcc`` for a ``.cu`` source,
    the host's C compiler (linked against the C math library) for a
    ``.c`` one."""
    src = source_path(name)
    if src.suffix == ".cu":
        return nvcc_command(name, out)
    return [cc_path(), *CC_FLAGS, "-o", str(out), str(src), "-lm"]


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
                    compile_command(name, Path(tmp)),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
            except (OSError, RuntimeError) as exc:
                os.unlink(tmp)
                raise RuntimeError(
                    f"cannot build {source_path(name).name}: {exc}"
                ) from exc
            procs[name] = (tmp, proc)
        failures = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {source_path(name).name} ---\n{log}")
                os.unlink(tmp)
            else:
                paths[name].with_suffix(".log").write_text(log)
                os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("build failed:\n" + "\n".join(failures))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def compiler_log(name: str) -> str:
    """What the compiler printed when it built ``name`` (for a ``.cu``
    source, ptxas's registers, shared memory and spills of each
    kernel), building the library first if it is missing."""
    return build([name])[name].with_suffix(".log").read_text()


def sass_opcodes(name: str, kernel: str) -> dict:
    """Opcode counts (with their modifiers, e.g. ``"DSETP.GEU.OR"``) of
    the SASS of every kernel of library ``name`` whose symbol contains
    ``kernel``, from the toolkit's ``cuobjdump -sass``."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build([name])[name])],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    inside = False
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inside = kernel in fn.group(1)
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)", line)
        if inside and op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.c``, built on
    first use), with ``argtypes`` set from ``signatures`` (function name
    -> list of ctypes types) and every listed function returning
    ``int``.  Each listed function is looked up in the library once, here,
    and kept as an attribute of the returned object; once loaded, a call
    is one dict lookup, without the lock."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            if source_path(name).suffix == ".cu":
                err = getattr(lib, f"{name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return lib


def call(lib: ctypes.CDLL, name: str, fn, device, *args) -> None:
    """Call C function ``fn`` of ``lib`` (library ``name``) with ``args``
    and the current stream of ``device``, and raise on a CUDA error.  The
    device is entered only when it is not the current one.  The device
    and the raw stream come from torch's C bindings (the ones its own
    compiled kernels use), without the Python objects of
    ``torch.cuda.current_device``/``current_stream``: a launch costs the
    host a few microseconds, about what the small kernels cost the card."""
    if device.index != torch._C._cuda_getDevice():
        with torch.cuda.device(device):
            return call(lib, name, fn, device, *args)
    check(lib, name,
          fn(*args, torch._C._cuda_getCurrentRawStream(device.index)))


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
