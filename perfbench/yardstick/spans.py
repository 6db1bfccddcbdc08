"""What the per-layer metrics compute from the program's span records
(``program_spans.records``: one a span, with its ``name``, ``parent``
and ``device_s``) and from the spans' host ranges in the trace.  With no
records, or no ranges, each gives no value."""
from __future__ import annotations

#: runtime calls that launch a kernel, as the profiler names them
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def device_s(records, names) -> float | None:
    """Summed ``device_s`` of the records named in ``names``; None when
    there is none."""
    got = [r["device_s"] for r in records if r["name"] in names]
    return sum(got) if got else None


def window_share(t, records, names) -> float | None:
    """``device_s`` of ``names`` as a percentage of the window."""
    s = device_s(records, names)
    return None if s is None else 100.0 * s / t.window_s


def busy_share(t, records, names) -> float | None:
    """``device_s`` of ``names`` as a percentage of the device's busy
    time in the window (a coverage, for names that do not nest)."""
    s = device_s(records, names)
    busy = t.busy_s
    return None if s is None or not busy else 100.0 * s / busy


def ranges(t, name: str) -> list:
    """``(start, end)`` of every host range of span ``name``, by start."""
    return [(s, e) for n, s, e in t.host if n == name]


def launches_in(t, spans: list) -> int:
    """Kernel-launch runtime calls that start inside one of ``spans``
    (``(start, end)`` pairs that do not overlap, by start)."""
    n, i = 0, 0
    for name, s, _ in t.host:
        while i < len(spans) and spans[i][1] < s:
            i += 1
        if i == len(spans):
            break
        if spans[i][0] <= s and name.startswith(LAUNCH):
            n += 1
    return n
