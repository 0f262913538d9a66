"""The native C++ audio loader through ``ctypes`` (counterpart of
``mptpu/data/native.py``): WAV decode and random-crop batching on
background threads, so that the device never waits on host IO.

The port builds its own copy of the C++ (``mptpu_torch/native/
dataloader.cpp``, the same code as ``native/dataloader.cpp``) with ``g++``
at first use, into ``build/mptpu_torch_native/<digest of the source>/``.
``NativeAudioLoader`` raises when that build fails; ``native_available()``
says whether it can be had.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "mptpu_torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]   # native/Makefile's

_lib = None
build_log = ""


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmptpu_torch_dataloader.so"


def build_native() -> bool:
    """Compile the loader if the library for the source's digest is
    missing; True when the library is there. The compiler's output stays
    in ``build_log``."""
    global build_log
    lib_path = _lib_path()
    if lib_path.exists():
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        build_log = "no C++ compiler (g++) found"
        return False
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # built under a name of its own and renamed, so that processes building
    # at once never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return False
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(str(_lib_path()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeAudioLoader:
    """Iterator of (batch_size, n_samples) float32 arrays, prefetched by
    ``n_threads`` C++ worker threads. Each thread has its own generator,
    so the order of the batches is fixed by ``seed`` only with one."""

    def __init__(self, paths: List[str], batch_size: int, n_samples: int, step_size: int = 1,
                 normalize: bool = False, seed: int = 0, n_prefetch: int = 4,
                 n_threads: int = 2):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (build failed: "
                               f"{build_log.strip()[:500]}); use mptpu_torch.data.batch_stream "
                               "instead")
        self._lib = lib
        self.batch_size = batch_size
        self.n_samples = n_samples
        encoded = [p.encode() for p in paths]
        # kept alive as long as the loader: its workers read the paths
        self._paths = (ctypes.c_char_p * len(encoded))(*encoded)
        self._handle = lib.loader_create(self._paths, len(encoded), batch_size, n_samples,
                                         step_size, int(normalize), seed, n_prefetch, n_threads)
        if not self._handle:
            raise RuntimeError("loader_create failed")
        self._buf = np.zeros((batch_size, n_samples), dtype=np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        rc = self._lib.loader_next(self._handle,
                                   self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        return self._buf.copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def native_available() -> bool:
    """Whether the loader's library is built or can be."""
    return _load_lib() is not None
