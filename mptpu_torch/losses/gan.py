"""Least-squares GAN losses (counterpart of ``mptpu/losses/gan.py``)."""

from __future__ import annotations

import torch

REAL_TARGET = 1.0
FAKE_TARGET = 0.0


def least_squares_generator_loss(j: torch.Tensor, real_target: float = REAL_TARGET):
    return 0.5 * torch.mean((j - real_target) ** 2)


def squared_gan_loss(value: torch.Tensor, target) -> torch.Tensor:
    return torch.mean((value - target) ** 2)


def least_squares_disc_loss(r_j: torch.Tensor, f_j: torch.Tensor,
                            real_target: float = REAL_TARGET,
                            fake_target: float = FAKE_TARGET) -> torch.Tensor:
    return 0.5 * (torch.mean((r_j - real_target) ** 2) + torch.mean((f_j - fake_target) ** 2))
