"""One-line description of this experiment (required: the runner refuses
an experiment without a docstring)."""

import torch

from mptpu_torch.data import AudioIterator
from mptpu_torch.device import default_device
from mptpu_torch.losses import iterative_loss
from mptpu_torch.models import OverfitHierarchicalEvents, splat_loss_transform


class Experiment:
    """Replace with a meaningful experiment description."""

    n_samples = 2 ** 15
    batch_size = 1

    def run(self, max_iterations: int = 100, device=None, model=None, noise=None, log=print):
        """Fit a splat of 16 events to one corpus segment with the iterative
        loss and Adam at 1e-3; returns the model and keeps each step's loss
        in ``self.losses``. ``model`` replaces the seeded one; ``noise(i)``
        gives step ``i``'s decoder noise (1, 1, n_samples), drawn from a
        generator seeded 0 when None. ``device``: ``cuda`` unless
        ``"cpu"``."""
        dev = default_device(device)
        if model is None:
            model = OverfitHierarchicalEvents(n_samples=self.n_samples, samplerate=22050,
                                              n_events=16, context_dim=16, device=dev)
        stream = iter(AudioIterator(self.batch_size, self.n_samples, normalize=True,
                                    overfit=True, device=dev))
        target = next(stream)
        gen = torch.Generator(device=dev).manual_seed(0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        losses = []
        for i in range(max_iterations):
            recon, _, _ = model(noise=None if noise is None else noise(i).to(dev), generator=gen)
            loss = iterative_loss(target, recon, splat_loss_transform)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if i % 10 == 0:
                log(f"iter {i} loss {float(losses[-1]):.4f}")
        self.losses = [float(v) for v in losses]
        return model


Current = Experiment
