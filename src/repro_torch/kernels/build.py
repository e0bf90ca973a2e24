"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
their sources, so an edited source is never served from a stale build.
Nothing is built when a module is imported: the first launch builds, or
:func:`build_all` builds every kernel at once, one ``nvcc`` per source in
parallel.

Launch counts: every kernel wrapper calls :func:`count_launch` right where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
KERNELS = ("dense_gemm", "griffin_spmm", "sparse_a", "batch_eval")
# launch counters: one per kernel function a wrapper launches (sparse_a.cu
# holds two: the GEMM and its activation metadata)
COUNTERS = KERNELS + ("sparse_a_meta",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, extra: Iterable[str] = ()) -> Tuple:
    """Start ``nvcc`` on one source into a temporary file of the build
    directory; :func:`_finish` moves it into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(proc: subprocess.Popen, tmp: str, cmd: List[str],
            out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = KERNELS, verbose: bool = False
              ) -> Dict[str, str]:
    """Build every named kernel that has no current library, one ``nvcc``
    per source, all started together.  ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel).  Returns the
    compiler's output by kernel name."""
    extra = ("-Xptxas", "-v") if verbose else ()
    started = []
    logs: Dict[str, str] = {}
    with _LOCK:
        for name in names:
            out = _lib_path(name)
            if out.exists() and not verbose:
                logs[name] = "(cached)"
                continue
            started.append((name, out) + _start(name, extra))
        errors = []
        for name, out, proc, tmp, cmd in started:
            try:
                logs[name] = _finish(proc, tmp, cmd, out)
            except RuntimeError as err:
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        out = _lib_path(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
