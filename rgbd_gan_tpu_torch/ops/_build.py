"""Build a CUDA source of ``csrc/`` with ``nvcc`` and load it with ctypes.

Each kernel source has a plain C interface. It is compiled for ``sm_90a``
at first use into ``build/`` at the repository root, under a name that
carries the hash of the source, so an edited source is rebuilt and an
unchanged one is reused. A failed build raises with ``nvcc``'s own error
text; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``.

    The library is written under a temporary name and renamed into place, so
    a concurrent or interrupted build never leaves a half-written file
    under the final name. Each source has its own lock, so that several
    sources build at once from several threads.
    """
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src_path = CSRC_DIR / f"{name}.cu"
        tag = hashlib.sha256(src_path.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src_path),
            ]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}) on {src_path.name}:\n{res.stderr}")
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def raise_on(err: int, name: str) -> None:
    """Raise when a kernel's entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
