"""ctypes binding to the repo-level native C++ ffmpeg decoder
(native/decode.cpp, native/decode_pool.cpp).

Builds lazily on first use (``make`` in native/); when the toolchain or the
ffmpeg dev libraries are absent, ``available()`` is False and reader.py uses
cv2.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libtspo_decode.so"))

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO_PATH):
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_SO_PATH)
            lib.tspo_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.tspo_probe.restype = ctypes.c_int
            lib.tspo_gather.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_longlong]
            lib.tspo_gather.restype = ctypes.c_longlong
            try:  # decode pool (decode_pool.cpp) — absent in stale builds
                lib.tspo_pool_create.argtypes = [ctypes.c_int]
                lib.tspo_pool_create.restype = ctypes.c_void_p
                lib.tspo_pool_submit.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong]
                lib.tspo_pool_submit.restype = ctypes.c_longlong
                lib.tspo_pool_wait.argtypes = [ctypes.c_void_p,
                                               ctypes.c_longlong]
                lib.tspo_pool_wait.restype = ctypes.c_longlong
                lib.tspo_pool_pending.argtypes = [ctypes.c_void_p]
                lib.tspo_pool_pending.restype = ctypes.c_int
                lib.tspo_pool_destroy.argtypes = [ctypes.c_void_p]
                lib.tspo_pool_destroy.restype = None
                lib._has_pool = True
            except AttributeError:
                lib._has_pool = False
            try:  # per-decoder ffmpeg thread budget — absent in stale builds
                lib.tspo_set_decode_threads.argtypes = [ctypes.c_int]
                lib.tspo_set_decode_threads.restype = None
                lib._has_thread_budget = True
            except AttributeError:
                lib._has_thread_budget = False
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def info(path: str):
    lib = _load()
    n = ctypes.c_longlong()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tspo_probe(path.encode(), ctypes.byref(n), ctypes.byref(fps),
                      ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native probe failed: {path}")
    return int(n.value), float(fps.value), int(w.value), int(h.value)


def pool_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_has_pool", False)


class DecodePool:
    """Native multi-video decode executor (native/decode_pool.cpp): a C++
    worker pool runs whole index-gathers concurrently — the cross-video
    parallelism the reference gets from one python process per GPU
    (mp_tools worker loop) lives in native threads here.

    Usage:
        with DecodePool(workers=4) as pool:
            job = pool.submit(path, indices)     # non-blocking
            frames = pool.result(job)            # [n, H, W, 3] uint8
    """

    def __init__(self, workers: int = 2):
        lib = _load()
        if lib is None or not lib._has_pool:
            raise RuntimeError("native decode pool unavailable")
        self._lib = lib
        self._pool = lib.tspo_pool_create(int(workers))
        self._bufs = {}          # job id -> (out array, idx array, n)
        if getattr(lib, "_has_thread_budget", False):
            # split the host's cores across the pool's concurrent gathers:
            # without this every gather frame-threads to ALL cores, and the
            # pool multiplies to workers x cores ffmpeg threads
            budget = max(1, (os.cpu_count() or 1) // max(int(workers), 1))
            lib.tspo_set_decode_threads(budget)

    def submit(self, path: str, indices: np.ndarray) -> int:
        nframes, _, w, h = info(path)
        idx = np.clip(np.asarray(indices, np.int64), 0, max(nframes - 1, 0))
        n = len(idx)
        out = np.empty((n, h, w, 3), np.uint8)
        job = self._lib.tspo_pool_submit(
            self._pool, path.encode(),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out.nbytes)
        # keep buffers alive until the worker finishes (C side borrows them)
        self._bufs[job] = (out, idx, n)
        return int(job)

    def result(self, job: int) -> np.ndarray:
        got = self._lib.tspo_pool_wait(self._pool, job)
        entry = self._bufs.pop(job, None)
        if entry is None:
            raise IOError(f"unknown or already-consumed pool job {job} "
                          f"({got})")
        out, _idx, n = entry
        if got != n:
            raise IOError(f"native pool gather failed ({got})")
        return out

    def pending(self) -> int:
        return int(self._lib.tspo_pool_pending(self._pool))

    def close(self):
        if self._pool is not None:
            for job in list(self._bufs):      # drain borrowed buffers first
                self._lib.tspo_pool_wait(self._pool, job)
                self._bufs.pop(job, None)
            self._lib.tspo_pool_destroy(self._pool)
            self._pool = None
            if getattr(self._lib, "_has_thread_budget", False):
                self._lib.tspo_set_decode_threads(0)   # back to all cores

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def gather(path: str, indices: np.ndarray) -> np.ndarray:
    lib = _load()
    nframes, _, w, h = info(path)
    idx = np.clip(np.asarray(indices, np.int64), 0, max(nframes - 1, 0))
    n = len(idx)
    out = np.empty((n, h, w, 3), np.uint8)
    got = lib.tspo_gather(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out.nbytes)
    if got != n:
        raise IOError(f"native gather failed ({got}): {path}")
    return out
