"""Build, load and count the port's CUDA kernels.

The sources under ``mptpu_torch/csrc/`` export a plain C interface. At
first use they are compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together, then one link) into
``build/mptpu_torch_kernels/<hash>/``, where the hash covers the sources
and the flags, so a changed source rebuilds. The shared library is
loaded with ``ctypes``. Importing this module needs no ``nvcc``: nothing
is built until a CUDA tensor reaches a kernel wrapper.

Every wrapper adds one to its entry in ``LAUNCHES`` for each launch of its
kernel (a chain of ``n_steps`` step launches enqueued by one C call adds
``n_steps``), and nowhere else, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "mptpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C function name -> argument types (pointers and the stream are void*)
_SIGNATURES = {
    "mp_fused_step": [_P] * 10 + [_I] * 14 + [_P],
    "mp_fused_encode": [_P] * 9 + [_I] * 14 + [_P],
    "mp_fused_encode_plan": [_I] * 6 + [_P],
    "mp_boundary_update": [_P] * 4 + [_I] * 6 + [_P],
    "mp_fused_step_pipelined": [_P] * 10 + [_I] * 15 + [_P],
    "mp_fused_step_pipelined_plan": [_I] * 6 + [_P],
    "mp_fused_encode_lane": [_P] * 10 + [_I] * 14 + [_P],
    "mp_fused_encode_lane_plan": [_I] * 6 + [_P],
    "probe_grid": [_P, _I, _I, _I, _P],
    "probe_loop": [_P, _I, _I, _P],
}

LAUNCHES = {
    "cuda_fused_step": 0,
    "cuda_fused_encode": 0,
    "cuda_boundary_update": 0,
    "cuda_fused_step_pipelined": 0,
    "cuda_fused_encode_lane": 0,
    "probe_launches": 0,
}

_lib = None
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if the library for their hash is missing;
    return the library's path. Raises with the compiler's output on
    failure."""
    global build_log
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libmptpu_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = out_dir / "libmptpu_kernels.so.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, counter: str, *args, count: int = 1) -> None:
    """Call C launcher ``name`` on the current stream, add the ``count``
    kernel launches it enqueues to ``counter`` and raise if CUDA reports an
    error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[counter] += count


def check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32, device=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    on ``device`` (a CUDA device)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
