"""The program's own spans in a traced stretch of calls, and where the card
sat idle by the program's layer.

``mptpu_torch.tracing.span`` puts each span in the profiler's trace as a
``user_annotation`` named ``mptpu.<layer>.<phase>``, on the clock of the
card's kernels (``tracing.Trace.host`` and ``.device``). The program opens
its spans on the calling thread alone, so they nest. Each instant of an
idle gap of the card inside the window goes to the innermost program span
open at that instant, or to ``OUTSIDE`` where none is open; the parts sum
to the window's idle time (``Trace.busy_s``'s union of device intervals,
taken from the window). The host's waits for the card are the synchronising
CUDA calls the trace holds inside program spans.

A reader finds nothing (None) in a trace with no device activity (a run
on the CPU) or with no program span (a program that opens none).
"""

from __future__ import annotations

PREFIX = "mptpu."
OUTSIDE = "outside"
# the runtime and driver calls in which the host waits for the card
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
})


def program_spans(t) -> list:
    """[(name, start us, end us)] of the program's spans, cut to the window,
    in order of start."""
    w0, w1 = t.window
    out = [(name, max(ts, w0), min(ts + dur, w1)) for name, ts, dur, cat in t.host
           if cat == "user_annotation" and name.startswith(PREFIX) and ts < w1 and ts + dur > w0]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def readable(t) -> bool:
    return bool(t.device) and bool(program_spans(t))


def idle_gaps(t) -> list:
    """[(start us, end us)] in which no device operation ran, inside the
    window, in order."""
    w0, w1 = t.window
    gaps, end = [], w0
    busy = sorted(t._inside())   # the device intervals Trace.busy_s takes
    for b0, b1 in busy:
        if b0 > end:
            gaps.append((end, b0))
        end = max(end, b1)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def idle_by_span(t) -> dict:
    """{span name or OUTSIDE: idle seconds}: each idle instant of the window
    under the innermost program span open then."""
    spans = program_spans(t)
    # the window cut at every span boundary; each piece's innermost open span
    cuts = sorted({t.window[0], t.window[1], *(x for _, s0, s1 in spans for x in (s0, s1))})
    pieces, i, open_ = [], 0, []
    for p0, p1 in zip(cuts[:-1], cuts[1:]):
        while i < len(spans) and spans[i][1] <= p0:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s[2] > p0]
        # nested spans: the innermost is the latest to start (the shorter at a tie)
        inner = max(open_, key=lambda s: (s[1], -s[2]))[0] if open_ else OUTSIDE
        pieces.append((p0, p1, inner))
    out, k = {}, 0
    gaps = idle_gaps(t)
    for p0, p1, name in pieces:
        while k < len(gaps) and gaps[k][1] <= p0:
            k += 1
        j, idle = k, 0.0
        while j < len(gaps) and gaps[j][0] < p1:
            idle += min(gaps[j][1], p1) - max(gaps[j][0], p0)
            j += 1
        if idle > 0:
            out[name] = out.get(name, 0.0) + idle / 1e6
    return out


def idle_ms(t, names):
    """Idle milliseconds a call under the spans ``names``; None where the
    trace holds none of them."""
    if not readable(t) or not any(s[0] in names for s in program_spans(t)):
        return None
    parts = idle_by_span(t)
    return sum(parts.get(n, 0.0) for n in names) / t.calls * 1e3


def outside_idle_ms(t):
    """Idle milliseconds a call under no program span."""
    if not readable(t):
        return None
    return idle_by_span(t).get(OUTSIDE, 0.0) / t.calls * 1e3


def host_ms(t, name):
    """Host milliseconds a call inside the spans ``name``."""
    found = [s for s in program_spans(t) if s[0] == name] if readable(t) else []
    return sum(s1 - s0 for _, s0, s1 in found) / 1e3 / t.calls if found else None


def count(t, name):
    """Spans ``name`` a call; None where the trace holds no program span."""
    if not readable(t):
        return None
    return sum(1 for s in program_spans(t) if s[0] == name) / t.calls


def waits(t):
    """The host's waits for the card a call inside the program's spans: the
    synchronising CUDA runtime and driver calls the trace holds there (a
    copy to or from pageable memory and ``.item()`` wait through
    ``cudaStreamSynchronize``). The harness's own synchronise between calls
    is under no program span."""
    if not readable(t):
        return None
    found = program_spans(t)
    syncs = [ts for name, ts, dur, cat in t.host
             if cat in ("cuda_runtime", "cuda_driver") and name in SYNC_CALLS]
    return sum(1 for ts in syncs if any(s0 <= ts < s1 for _, s0, s1 in found)) / t.calls
