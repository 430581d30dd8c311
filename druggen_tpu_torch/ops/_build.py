"""Build a CUDA source into a shared library with ``nvcc`` and cache it.

Each source in ``csrc/`` exposes a plain ``extern "C"`` interface and is
compiled on its own into ``_build/<stem>-<hash>.so`` (the directory is not
tracked), keyed by the source bytes and the flags, so an unchanged kernel is
compiled once per checkout.  The library is loaded with ``ctypes``; no
PyTorch headers are involved, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when taken from the cache)
    log: str            # nvcc's output, including ``-Xptxas -v``
    cached: bool


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (or return the cached library)."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return Built(lib, 0.0, log.read_text() if log.exists() else "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return Built(lib, seconds, proc.stdout + proc.stderr, False)


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build(name).path))
