"""Spans of the program's layers, for a profiler to read.

``span(name)`` marks a phase of a call as one of the program's layers. With
no profiler running it does nothing: it reads one flag,
``torch.autograd.profiler._is_profiler_enabled``, and returns a shared no-op
context, since ``record_function`` costs about 11 us a use even with the
profiler off. With a profiler running it enters
``torch.profiler.record_function(name)``: the span lands in the profiler's
Chrome trace as a ``user_annotation`` on the same clock as the card's
kernels, so an idle gap of the card can be put down to the layer the host
was in. The spans wrap whole phases of a call, never a greedy step or an
atom of the learning update.

``SPANS`` names every span with the layer it belongs to (the layers of
``BENCHMARK.json``). A wait of the host for the card shows in the same
trace as a synchronising CUDA runtime call inside the span that made it.
The program's counter is ``kernels.LAUNCHES``, the launches of each CUDA
kernel.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

SPANS = {
    # sparse_code_fast: dictionary_gram and, on the kernels' path, its lag pad
    "mptpu.mp.gram": "encode state",
    # sparse_code_fast: encode_state and the block-max table's pad
    "mptpu.mp.state": "encode state",
    # sparse_code_fast: the greedy loop, kernel launches or PyTorch steps
    "mptpu.mp.loop": "greedy-loop kernels",
    # MultibandDictionaryLearning.encode and .learn: the octave split
    "mptpu.multiband.split": "encode state",
    # dictionary_learning_step: the events' copy to the host, the grouping
    # by atom and the upload of their order
    "mptpu.learn.groups": "learning update",
    # dictionary_learning_step: the update of every used atom, then the
    # dictionary's norms
    "mptpu.learn.update": "learning update",
}

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the span ``name`` (a key of ``SPANS``): a
    ``record_function`` while a profiler runs, else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
