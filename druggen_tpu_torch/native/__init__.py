"""ctypes bindings for the native chem kernel (``chem.cpp``).

The Python API and the ctypes signatures are those of
``druggen_tpu/native/__init__.py``, and ``chem.cpp`` is a byte-equal copy of
``druggen_tpu/native/chem.cpp``: multithreaded SMILES parse, sanitize,
featurization and vocabulary scan, bit-identical to the pure-Python path
(:mod:`druggen_tpu_torch.chem`).  It is host code; nothing of it runs on the
card.

The build differs from the JAX package's ``make``: at first use the source
is compiled with ``$CXX`` (default ``g++``) and the JAX Makefile's flags
into ``druggen_tpu_torch/ops/_build/libdruggen_chem-<key>.so`` (not
tracked), keyed by the source, the compiler, the flags and the host's
machine type (``-march=native``).  Concurrent builds (test workers) take a
file lock, and the library is written under a temporary name and renamed
into place.  A build or load that fails raises ``RuntimeError`` with the
compiler's output: the port never falls back to the Python path on its own
(``use_native=False`` is the explicit way there).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "chem.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")
ABI_VERSION = 1
_lib = None


def compiler() -> str:
    """``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library for this source, compiler, flags and machine type
    lands."""
    key = b"\0".join([SOURCE.read_bytes(), compiler().encode(),
                      " ".join(CXX_FLAGS).encode(), platform.machine().encode()])
    return BUILD_DIR / f"libdruggen_chem-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``chem.cpp`` unless its library exists; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libdruggen_chem.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():             # another process built it meanwhile
            return lib
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
        except OSError as exc:
            raise RuntimeError(f"native chem build: cannot run {cmd[0]!r} "
                               f"(set CXX to a C++17 compiler): {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native chem build failed (exit "
                               f"{proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise RuntimeError(f"native chem library {path} does not load: "
                           f"{exc}") from exc
    lib.dg_abi_version.restype = ctypes.c_int
    if lib.dg_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native chem library {path}: ABI "
                           f"{lib.dg_abi_version()}, expected {ABI_VERSION}")
    lib.dg_featurize.restype = ctypes.c_int
    lib.dg_featurize.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8)]
    lib.dg_featurize_batch.restype = None
    lib.dg_featurize_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.dg_vocab_scan.restype = None
    lib.dg_vocab_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def vocab_scan_available() -> bool:
    """The library built from this checkout always exports the scan."""
    return hasattr(_load(), "dg_vocab_scan")


def _vocab_arrays(vocab):
    atom = np.asarray(vocab.atom_labels, dtype=np.int64)
    bond = np.asarray(vocab.bond_labels, dtype=np.int64)
    return atom, bond


def _buffer(smiles_list) -> tuple[bytes, np.ndarray]:
    """The SMILES joined by newlines, and each one's byte offset."""
    encoded = [s.encode() for s in smiles_list]
    lengths = np.fromiter((len(b) + 1 for b in encoded), np.int64, len(encoded))
    offsets = np.zeros(len(encoded), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    return b"\n".join(encoded), offsets


def featurize_smiles_native(smiles: str, vocab, max_atom: int):
    """Single-molecule native featurization; None if rejected (same contract
    as chem.codec.smiles_to_matrices)."""
    lib = _load()
    atom, bond = _vocab_arrays(vocab)
    X = np.zeros(max_atom, dtype=np.int8)
    A = np.zeros((max_atom, max_atom), dtype=np.int8)
    r = lib.dg_featurize(
        smiles.encode(), max_atom,
        atom.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(atom),
        bond.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(bond),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if r <= 0:
        return None
    return X, A


def featurize_batch_native(smiles_list, vocab, max_atom: int,
                           n_threads: int = 0):
    """Multithreaded batch featurization (``n_threads`` 0: the library's
    default).

    Returns (X [M,N] int8, A [M,N,N] int8, kept_indices list[int])."""
    lib = _load()
    atom, bond = _vocab_arrays(vocab)
    buf, offsets = _buffer(smiles_list)
    n = len(smiles_list)
    X = np.zeros((n, max_atom), dtype=np.int8)
    A = np.zeros((n, max_atom, max_atom), dtype=np.int8)
    keep = np.zeros(n, dtype=np.int32)
    lib.dg_featurize_batch(
        buf, len(buf), n,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_atom,
        atom.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(atom),
        bond.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(bond),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    kept = np.nonzero(keep > 0)[0]
    return X[kept], A[kept], kept.tolist()


def vocab_scan_native(smiles_list, max_atom: int, n_threads: int = 0):
    """Multithreaded vocabulary scan: returns (atomic_nums, bond_types) as
    sorted lists of ints present across molecules that parse and have
    <= max_atom atoms (build_vocab semantics, reference
    src/data/utils.py:83-109)."""
    lib = _load()
    buf, offsets = _buffer(smiles_list)
    atom_mask = np.zeros(256, dtype=np.uint8)
    bond_mask = np.zeros(64, dtype=np.uint8)
    lib.dg_vocab_scan(
        buf, len(buf), len(smiles_list),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_atom,
        atom_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bond_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return (np.nonzero(atom_mask)[0].tolist(),
            np.nonzero(bond_mask)[0].tolist())
