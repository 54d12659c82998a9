"""Build a kernel source under ``csrc/`` into a shared library and load it.

Every Hopper kernel of the port is one ``.cu`` file with a plain C interface.
:func:`build` compiles it with ``nvcc`` for sm_90a at first use into
``build/tspo_tpu_torch/`` (listed in ``.gitignore``), keyed by a hash of the
source and the flags, and :func:`load` opens it with ctypes once per process.
Several sources build in parallel: one ``nvcc`` each, started together by the
caller's threads.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tspo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "tspo_tpu_torch/csrc with the CUDA toolkit")


def build(name: str, src_path: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu``, or ``src_path`` under that name (once per
    source hash), and return the shared library's path.  Safe to call from
    several threads or processes: the library is written under a temporary
    name and renamed into place."""
    src_path = src_path or CSRC / f"{name}.cu"
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtspo_{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_path.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, symbols: dict[str, list]) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, with each entry point of
    ``symbols`` (name -> argument types) given its argument types and an int
    return (the CUDA error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for symbol, argtypes in symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
