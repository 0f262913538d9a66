"""Ops with hand-written gradients (counterpart of
``mptpu/ops/custom_grads.py``): each ``jax.custom_vjp`` there is a
``torch.autograd.Function`` here, with the same forward and the same
backward.

- ``scalar_position``: a one-hot at ``int(position * n * 0.9999)``; the
  position's gradient is the incoming gradient's mass to the right of
  the index less its mass to the left.
- ``differentiable_fft_shift``: ``fft_shift``; the gradient passes to
  the items unchanged and the positions get zeros.
- ``schedule_atoms``: clips placed hard at their positions; the backward
  ignores the incoming gradient and returns, for each clip, its error at
  the position that best correlates with the target, and for each
  position its distance from that position.
- ``diff_index``: the nearest palette entry; the index moves towards the
  neighbour that better fits the error, the palette gets no gradient.
"""

from __future__ import annotations

import torch

from .fft import fft_shift, real_ends


def _correlate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross-correlation of ``a`` with ``b`` over twice their length, cut
    to the first half."""
    n = a.shape[-1]
    sa = torch.fft.rfft(a, n=2 * n, dim=-1)
    sb = torch.conj(torch.fft.rfft(b, n=2 * n, dim=-1))
    return torch.fft.irfft(real_ends(sa * sb), n=2 * n, dim=-1)[..., :n]


def position_render(positions: torch.Tensor, clips: torch.Tensor, n_samples: int,
                    sum_channels: bool = False) -> torch.Tensor:
    """Each clip (batch or 1, n_clips, clip length) placed at sample
    ``int(position * n_samples)`` of ``n_samples`` zeros, its tail cut at
    the end. The start is placed as ``lax.dynamic_update_slice`` places
    it into ``2 n`` zeros: a negative start counts from the end (``2 n``
    is added), then it is clamped to [0, 2 n - clip length].
    ``positions`` is (batch, n_clips)."""
    batch, n_clips = positions.shape
    if clips.shape[0] == 1:
        clips = clips.expand(batch, *clips.shape[1:])
    length = clips.shape[-1]
    starts = (positions * n_samples).to(torch.int32).to(torch.int64)
    starts = torch.where(starts < 0, starts + 2 * n_samples, starts)
    starts = torch.clamp(starts, 0, 2 * n_samples - length)
    idx = starts[..., None] + torch.arange(length, device=clips.device)
    out = torch.zeros(batch, n_clips, 2 * n_samples, dtype=clips.dtype, device=clips.device)
    out = out.scatter(-1, idx, clips)[..., :n_samples]
    if sum_channels:
        out = torch.sum(out, dim=1, keepdim=True)
    return out


class _ScalarPosition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, n_samples):
        indices = (positions * n_samples * 0.9999).to(torch.int32).to(torch.int64)
        ctx.save_for_backward(indices)
        ctx.pos_shape = positions.shape
        batch, n_examples = positions.shape[:2]
        grid = torch.arange(n_samples, device=positions.device)
        return (grid == indices.reshape(batch, n_examples, 1)).to(positions.dtype)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        # sum(g[idx:]) - sum(g[:idx]) = total - 2 * (the exclusive prefix at idx)
        total = torch.sum(g, dim=-1)
        prefix = torch.cat([torch.zeros_like(g[..., :1]), torch.cumsum(g, dim=-1)], dim=-1)
        idx = indices.reshape(indices.shape[0], -1, 1)
        before = torch.gather(prefix, -1, idx)[..., 0]
        return (total - 2.0 * before).reshape(ctx.pos_shape), None


def scalar_position(positions: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(batch, n_examples[, 1]) positions in [0, 1) -> (batch, n_examples,
    n_samples) one-hots."""
    return _ScalarPosition.apply(positions, n_samples)


class _FFTShifter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, items, positions):
        ctx.pos = (positions.shape, positions.dtype, positions.device)
        return fft_shift(items, positions)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.pos
        return g, torch.zeros(shape, dtype=dtype, device=device)


def differentiable_fft_shift(items: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``fft_shift(items, positions)`` with the straight-through gradient to
    ``items`` and zeros to ``positions``."""
    return _FFTShifter.apply(items, positions)


class _ScheduleAtoms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, items, positions, targets):
        ctx.save_for_backward(items, positions, targets)
        return position_render(positions, items, items.shape[-1])

    @staticmethod
    def backward(ctx, g):
        clips, pos, targets = ctx.saved_tensors
        batch, n_samples = g.shape[0], g.shape[-1]
        targets_v = targets.reshape(batch, 1, n_samples)
        clips_v = clips.reshape(-1, pos.shape[1], n_samples)
        conv = _correlate(targets_v, clips_v)
        real_best = (torch.argmax(conv, dim=-1) / conv.shape[-1]).to(pos.dtype)
        best_render = fft_shift(clips_v, real_best[..., None])
        clip_loss = fft_shift(best_render - targets_v, -real_best[..., None])
        return clip_loss.reshape(clips.shape), pos - real_best, None


def schedule_atoms(items: torch.Tensor, positions: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Clips (batch or 1, n_clips, n) rendered hard at ``positions``
    (batch, n_clips); the backward as the module says."""
    return _ScheduleAtoms.apply(items, positions, targets)


def _hard_indices(soft: torch.Tensor, size: int) -> torch.Tensor:
    indices = torch.clamp(soft, -0.999, 0.999).reshape(-1)
    hard = torch.round(((indices + 1) / 2) * size).to(torch.int32).to(torch.int64)
    return torch.clamp(hard, 0, size - 1)


class _DiffIndex(torch.autograd.Function):
    @staticmethod
    def forward(ctx, palette, indices):
        p = palette.reshape(-1)
        hard = _hard_indices(indices, p.shape[0])
        sampled = p[hard]
        ctx.save_for_backward(p, hard, sampled)
        ctx.idx_shape = indices.shape
        return sampled.reshape(indices.shape)

    @staticmethod
    def backward(ctx, g):
        p, hard, sampled = ctx.saved_tensors
        size = p.shape[0]
        left = torch.clamp(hard - 1, 0, size - 1)
        right = torch.clamp(hard + 1, 0, size - 1)
        error = g.reshape(-1)
        left_grad = torch.abs(error - (sampled - p[left]) - error)
        right_grad = torch.abs(error - (sampled - p[right]))
        grad = torch.sign(right_grad - left_grad) * (2.0 / size)
        return None, grad.reshape(ctx.idx_shape)


def diff_index(palette: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``palette``'s entry nearest to each index in [-1, 1] (rounded from
    ``(index + 1) / 2 * size``); the index's gradient is ``+-2 / size``
    towards the neighbour that better fits the incoming error, the
    palette's none."""
    return _DiffIndex.apply(palette, indices)
