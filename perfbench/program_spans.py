"""The benchmark's door to the program's own spans, beside ``program.py``:
the one reader of ``repro_torch.telemetry.spans.records()`` in a traced
run.  The yardstick imports nothing of the program, so what it computes
from the records (``yardstick/spans.py``) takes them from here."""
from __future__ import annotations


def records(t) -> list:
    """The program's span records of the traced window ``t`` (one a span:
    name, parent, step or request, ``device_s`` between two CUDA events,
    the caching allocator's deltas): read once, kept on ``t`` as
    ``t.spans``.  The profiler runs only around the window, so the
    program's latest session is the window.  A program without spans (a
    tree older than them) gives none."""
    if "spans" not in vars(t):
        try:
            from repro_torch.telemetry import spans
        except ImportError:
            t.spans = []
        else:
            t.spans = spans.records()
    return t.spans
