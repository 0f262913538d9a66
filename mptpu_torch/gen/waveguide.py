"""Karplus-Strong / waveguide synthesis (counterpart of
``mptpu/gen/waveguide.py``): ``WaveguideSynth`` in the frequency domain
(a comb-delay choice times a damping times a filter, one spectral
product), and the per-sample recurrence ``waveguide_synth_scan``.

``mptpu`` runs the recurrence as a ``lax.scan`` over a buffer it writes
and reads back. Every output below sample ``i`` is final at step ``i``
(the output is read at ``i - delay`` after it was written), and the delays
and filter sizes are integers, read to the host once; so the port keeps
the finished samples in a list and stacks them at the end, which keeps
autograd through the whole recurrence. It launches a few kernels a
sample: at 2^15 samples the host's launch rate sets its pace.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import default_device
from ..nn.init import uniform
from ..ops.fft import irfft, real_ends, rfft
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import linspace


class WaveguideSynth(nn.Module):
    """``forward(impulse, delay_selection, damping, filt, noise=None,
    generator=None)``: impulse (batch, frames), delay selection (batch,
    max_delay, frames'), damping (batch, 1), filter (batch, filter frames)
    -> (batch, 1, n_samples). The squared, upsampled impulse excites
    ``noise`` (batch, 1, n_samples), uniform in [-1, 1), drawn from
    ``generator`` when not given. The delay table (max_delay, n_samples),
    row ``i`` a one every ``i + 1`` samples, is a buffer built once on the
    device."""

    def __init__(self, max_delay: int = 512, n_samples: int = 2**15,
                 filter_kernel_size: int = 512, device=None):
        super().__init__()
        dev = default_device(device)
        self.n_delays = max_delay
        self.n_samples = n_samples
        self.filter_kernel_size = filter_kernel_size
        rows = torch.arange(max_delay, device=dev)[:, None]
        cols = torch.arange(n_samples, device=dev)[None, :]
        self.register_buffer("delays", (cols % (rows + 1) == 0).to(torch.float32),
                             persistent=False)

    def noise_shape(self, batch: int):
        return (batch, 1, self.n_samples)

    def forward(self, impulse, delay_selection, damping, filt,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        batch = delay_selection.shape[0]
        n_frames = filt.shape[-1]
        f = torch.sigmoid(filt).reshape(-1, 1, n_frames)
        f = interpolate_last_axis(f, self.n_samples // 2)
        filt_spec = torch.nn.functional.pad(f, (0, 1))

        impulse = interpolate_last_axis(impulse.reshape(batch, 1, -1) ** 2, self.n_samples)
        if noise is None:
            noise = uniform(self.noise_shape(batch), -1.0, 1.0, generator, impulse.device)
        impulse = impulse * noise.to(impulse.device, impulse.dtype)

        damping = torch.sigmoid(damping.reshape(batch, 1)) * 0.9999
        powers = linspace(1.0, float(damping.shape[-1]), n_frames, device=damping.device,
                          dtype=damping.dtype)
        damping = damping[:, :, None] ** powers[None, None, :]
        damping = interpolate_last_axis(damping, self.n_samples, mode="nearest")

        sel = torch.softmax(delay_selection.reshape(batch, self.n_delays, -1), dim=1)
        sel = interpolate_last_axis(sel, self.n_samples, mode="nearest")
        d = torch.sum(sel * self.delays.to(sel.dtype), dim=1, keepdim=True) * damping

        spec = rfft(d, norm="ortho") * rfft(impulse, norm="ortho") * filt_spec
        return irfft(real_ends(spec), n=self.n_samples, norm="ortho")


def waveguide_synth_scan(impulse: torch.Tensor, delay: torch.Tensor, damping: torch.Tensor,
                         filter_size: torch.Tensor, max_filter: int = 32) -> torch.Tensor:
    """The sequential waveguide on (n_samples,) inputs: sample ``i`` is
    ``impulse[i]`` plus the mean of the last ``filter_size[i]`` (clipped
    to [0, max_filter]) delayed values before it, where the delayed value
    of sample ``k`` is ``out[k - delay[k]] * damping[k]`` when ``k >
    delay[k]``, else 0; with no value before it, its own delayed value.
    ``delay`` and ``filter_size`` are truncated to integers, as ``mptpu``'s
    ``astype(int32)``. Differentiable in ``impulse`` and ``damping``."""
    n = impulse.shape[0]
    delays = delay.to(torch.int64).tolist()
    sizes = np.clip(np.asarray(filter_size.to(torch.int64).tolist()), 0, max_filter).tolist()
    imp = impulse.unbind(0)
    damp = damping.to(impulse.dtype).unbind(0)
    zero = impulse.new_zeros(())
    out, buf = [], []
    for i in range(n):
        if i > delays[i]:
            k = min(max(i - delays[i], 0), n - 1)
            # samples before i are final; from i on, the output is still the impulse
            delay_val = (out[k] if k < i else imp[k]) * damp[i]
        else:
            delay_val = zero
        count = min(sizes[i], i)
        if count:
            new_val = torch.stack(buf[i - count:i]).sum() / count
        else:
            new_val = delay_val
        buf.append(delay_val)
        out.append(imp[i] + new_val)
    return torch.stack(out)
