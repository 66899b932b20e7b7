"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds.  Libraries land in
``<checkout>/build/repro_torch_kernels/`` (override with the
``REPRO_TORCH_BUILD_DIR`` environment variable), named by a hash of the
source text and the compiler flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built at import: the first launch of
a kernel (or an explicit :func:`build_all`) triggers the build.  A failed
build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "find_nvcc", "build_all",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("skinny_gemm", "conv2d", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600.0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise RuntimeError(f"kernel source missing: {src}")
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (name, out, tmp, log, proc) or
    None when the library is already built."""
    src, out = _target(name)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = out.with_suffix(".log")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, log, proc


def _finish(job) -> None:
    name, out, tmp, log, proc = job
    try:
        text, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}.cu") from None
    log.write_text(text or "")
    if proc.returncode != 0 or not tmp.is_file():
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file


def build_all() -> dict:
    """Build every kernel source that is not built yet, all compilers
    started together.  Returns ``{"seconds", "built", "libs", "ptxas"}``."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [j for j in (_start(n) for n in SOURCES) if j is not None]
        err = None
        for j in jobs:
            try:
                _finish(j)
            except RuntimeError as e:  # reap every compiler before raising
                err = err or e
        if err is not None:
            raise err
    libs = {n: str(_target(n)[1]) for n in SOURCES}
    ptxas = {}
    for n in SOURCES:
        log = Path(libs[n]).with_suffix(".log")
        ptxas[n] = log.read_text() if log.is_file() else ""
    return {"seconds": time.perf_counter() - t0,
            "built": [j[0] for j in jobs], "libs": libs, "ptxas": ptxas}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
    return lib
