"""The experiment runner: a stream into a train step, monitored values,
the loss series and periodic checkpoints (counterpart of
``mptpu/train/runner.py``)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..convert import params_from_numpy
from ..device import default_device
from ..obs.collection import Collection
from .checkpoint import CheckpointManager


class BaseExperimentRunner:
    """Subclass or compose.

    ``train_step(params, opt_state, batch, generator) -> (params,
    opt_state, loss, recon)`` drives the loop. Iteration ``i``'s generator
    is a ``torch.Generator`` on ``device`` seeded from ``(seed, i)``, where
    ``mptpu`` folds ``i`` into its key; ``draws(i)``, when given, replaces
    it with whatever the step takes instead. Assigning ``self.real`` or
    ``self.fake`` logs the value to the collection. Each iteration reads
    its loss on the host (``float``), as ``mptpu`` does.
    """

    def __init__(self, stream: Iterable, train_step: Callable, params, opt_state,
                 checkpoint_dir: str = "trained_weights", checkpoint_every: int = 1000,
                 collection: Optional[Collection] = None, seed: int = 0,
                 draws: Optional[Callable[[int], object]] = None, device=None):
        self.stream = stream
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.ckpt = CheckpointManager(checkpoint_dir, every=checkpoint_every)
        self.collection = collection
        self.seed = seed
        self.draws = draws
        self.device = default_device(device)
        self.losses: list[float] = []
        self.iteration = 0

    def _log(self, name: str, value):
        if self.collection is not None:
            self.collection.log(name, value)

    def __setattr__(self, name, value):
        # monitored values: assigning real / fake logs them
        if name in ("real", "fake") and getattr(self, "collection", None):
            self._log(name, value)
        object.__setattr__(self, name, value)

    def key(self, iteration: int):
        """Iteration ``iteration``'s draw, or its generator."""
        if self.draws is not None:
            return self.draws(iteration)
        seed = int(np.random.SeedSequence([self.seed, iteration]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def after_training_iteration(self, loss):
        self.losses.append(float(loss))
        self._log("loss", np.asarray(self.losses[-100:]))
        self.ckpt.maybe_save(self.iteration, self.params, self.opt_state)

    def resume(self) -> int:
        """Take the newest checkpoint's parameters, optimiser state and step
        (tensors on ``device``); returns the step (unchanged without one)."""
        payload = self.ckpt.latest()
        if payload is not None:
            self.params = params_from_numpy(payload["params"], self.device)
            if payload["opt_state"] is not None:
                self.opt_state = params_from_numpy(payload["opt_state"], self.device)
            self.iteration = payload["step"]
        return self.iteration

    def run(self, max_iterations: Optional[int] = None):
        for item in self.stream:
            k = self.key(self.iteration)
            self.real = item
            self.params, self.opt_state, loss, recon = self.train_step(
                self.params, self.opt_state, item, k)
            self.fake = recon
            self.after_training_iteration(loss)
            self.iteration += 1
            if max_iterations is not None and self.iteration >= max_iterations:
                break
        return self.params
