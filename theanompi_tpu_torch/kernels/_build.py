"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles
with ``nvcc`` for ``sm_90a`` into its own shared library under the
checkout's ``build/`` directory, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  A library is named by a digest of
its sources and flags, so an edited source rebuilds and a stale
library is never loaded.  Builds happen at first use from the sources
in the repository; :func:`build` starts one ``nvcc`` per source, all at
once.

Nothing here runs at import: the CPU tests import every module, and
the CPU path (the kernels' plain versions) never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "theanompi_tpu_torch"
)
SOURCES = ("flash_fwd", "flash_bwd", "paged_attend", "rms_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "port's kernels build from csrc/ on a machine with the CUDA "
            "toolkit"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` process per source, all started together.  Returns
    each compiled source's ``nvcc``/``ptxas`` report (registers,
    shared memory, spills); raises with the report when one fails."""
    nvcc = nvcc_path()
    started = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        started.append((name, out, tmp, proc))
    reports, failed = {}, []
    for name, out, tmp, proc in started:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)     # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.tm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tm_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err:
        msg = lib.tm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
