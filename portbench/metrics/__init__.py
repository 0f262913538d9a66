"""Per-layer metric readers, each with ``read(trace)`` over
``tracing.Trace``; a reader that finds nothing to read returns None. A
metric's reader is ``<metric>.py``; a metric ``<prefix>.<reader>`` with no
file of its own reads through the shared ``<reader>.py`` (``encode.mfu``
and ``learn.mfu`` through ``mfu.py``)."""
