"""End-to-end metric readers, one module a metric, each with ``read(window)``
over ``run.Window`` (host-clock seconds of the closed loop, its calls, the
work they completed, each call's latency, and the set-up before it)."""
