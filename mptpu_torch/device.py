"""Device choice and float32 precision for the PyTorch port.

The port runs on a CUDA card unless the caller asks for the CPU. There is
no quiet fallback: asking for CUDA where there is none raises.

``mptpu`` accumulates every convolution and matrix product in float32
(``mptpu/ops/correlation.py:45-52``, ``mptpu/sparse/fast_mp.py:56-63``).
cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits, so the port turns TF32 off around its own
convolutions (``no_tf32``) and ``parity_mode`` turns it off for the
whole process.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller passes ``"cpu"`` (or another device).

    Raises ``RuntimeError`` when CUDA is asked for but not available; it
    never picks the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def parity_mode() -> None:
    """Run float32 matrix products and convolutions in full float32 (no
    TF32) for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextmanager
def no_tf32():
    """Full float32 for the convolutions and matrix products inside the
    block; the previous settings come back afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def grid_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 for a float64 tensor, float32 otherwise: the precision in
    which ``mptpu`` computes a grid or a constant next to ``x`` (JAX's
    default float under x64 or not)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32
