"""mptpu_torch: the PyTorch / CUDA port of ``mptpu`` for NVIDIA Hopper.

Module paths mirror ``mptpu``'s, so each counterpart sits at the same
path. Each Pallas kernel of ``mptpu`` becomes a CUDA C++ kernel under
``csrc/``, built at first use by ``mptpu_torch.kernels``; beside each
kernel sits a plain PyTorch version that CPU tensors take. This package
imports ``torch``, ``numpy`` and, for ``make_waves``, ``scipy.signal``.
"""

from .device import default_device, parity_mode, no_tf32

__all__ = ["default_device", "parity_mode", "no_tf32"]
