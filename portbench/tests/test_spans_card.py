"""On a card only, each cell at its full size: the host's waits that the
trace shows inside the program's spans (``spans.waits``) against those that
``torch.cuda.set_sync_debug_mode("warn")`` reports in the same traced call,
and a traced stretch's idle time split by the program's spans
(``portbench/spans.py``)."""

import warnings

import pytest
import torch

from portbench import run, spans, tracing
from portbench.tests.small import cells

SYNC_WARNING = "called a synchronizing CUDA operation"


def entry_of(name, seed, device):
    spec = run.load_spec(name)
    return spec, spec.entry.Entry(spec.config, spec.traffic, seed, device)


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_the_sync_reader_misses_no_wait(card, name):
    _, entry = entry_of(name, 2**31 + 79, card)
    caught = []

    def one_call(calls):
        with warnings.catch_warnings(record=True) as found:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                entry.call(0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        caught.extend(found)

    try:
        entry.warm()
        trace = tracing.profile_calls(one_call, 1, {}, run.device_peaks(run.card_name()),
                                      lambda: torch.cuda.synchronize(card))
    finally:
        entry.release()
    waits = [f"{w.filename}:{w.lineno}" for w in caught if SYNC_WARNING in str(w.message)]
    assert spans.waits(trace) == len(waits), waits


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_the_idle_parts_sum_to_the_idle_time(card, name):
    spec, entry = entry_of(name, 2**31 + 80, card)
    try:
        entry.warm()
        sampler = run.Sampler(0, 0)
        trace, _ = run.traced(entry, spec, sampler, lambda: torch.cuda.synchronize(card),
                              run.device_peaks(run.card_name()))
    finally:
        entry.release()
    parts = spans.idle_by_span(trace)
    idle = trace.window_s - trace.busy_s()
    assert set(parts) - {spans.OUTSIDE}, parts
    assert sum(parts.values()) == pytest.approx(idle, rel=0.01)
    for m in spec.per_layer():
        value = run.module_at("metrics", run.reader_path(m["name"]).stem).read(trace)
        assert value is not None, m["name"]
