"""The benchmark of ``mptpu_torch`` on one NVIDIA H100: see README.md."""
