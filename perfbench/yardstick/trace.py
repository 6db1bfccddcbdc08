"""The traced window: ``torch.profiler`` (CPU and CUDA) around the window,
reduced to device intervals, kernel times by name and idle gaps.

The window's bounds are the ``perfbench.window`` span the harness
records, so a trace's time is the window's and not the profiler's.  The
reduction reads the profiler's raw events (``kineto_results.events()``),
never the aggregated tables, which take minutes on a window of many
thousands of launches.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

WINDOW_SPAN = "perfbench.window"
SPAN_PREFIX = "perfbench."
NON_KERNEL = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    """One traced window.  Times are ns on the profiler's clock."""
    t0: int
    t1: int
    device: list        # (name, start, end) of every device operation
    host: list          # (name, start, end) of the host's events, by start
    info: dict          # what the driver knows of the work in the window
    peak: dict | None   # the card's published peaks, None if unknown

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self, match=None):
        """Kernel launches (no copies or fills) whose name ``match``
        accepts (all when None)."""
        return [k for k in self.device if not k[0].startswith(NON_KERNEL)
                and (match is None or match(k[0]))]

    @staticmethod
    def seconds(events) -> float:
        return sum(e - s for _, s, e in events) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's operations, clipped to the window."""
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.device if e > self.t0 and
                       s < self.t1)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list:
        """``(start, end)`` of every stretch of the window in which no
        device operation ran."""
        gaps, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def host_doing(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost harness span,
        and the outermost and innermost program operations open then."""
        i = bisect.bisect_right(self._starts, t)
        span, ops = None, []
        for name, s, e in self.host[max(0, i - 20000):i]:
            if e < t or name == WINDOW_SPAN:
                continue
            if name.startswith(SPAN_PREFIX):
                span = name[len(SPAN_PREFIX):]
            else:
                ops.append((s, name))
        ops.sort()
        what = "no operation" if not ops else ops[0][1] if len(ops) == 1 \
            else f"{ops[0][1]} > {ops[-1][1]}"
        return f"{span or 'window'}/{what}"

    @property
    def _starts(self) -> list:
        if not hasattr(self, "_starts_cache"):
            self._starts_cache = [s for _, s, _ in self.host]
        return self._starts_cache

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time (by name) and
        the ``n`` longest idle gaps, named by what the host was doing."""
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0) + e - s
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k[:200], v / 1e9] for k, v in ops],
                "idle_gaps": [[self.host_doing((s + e) // 2), (e - s) / 1e9]
                              for s, e in gaps]}


@contextlib.contextmanager
def window_span():
    """The span that marks the window (a no-op without a profiler)."""
    import torch
    with torch.profiler.record_function(WINDOW_SPAN):
        yield


def span(name: str):
    """A harness span ``perfbench.<name>`` around a call into the
    program."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def reduce(prof, info: dict, peak) -> Trace:
    """The raw events of a finished ``profiler()`` as a :class:`Trace`;
    raises when the window's span or any device operation is missing."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    # a span recorded on the host is mirrored on the device's timeline
    # (its GPU user annotation): not an operation of the device
    spans = {name for name, _, _ in host} | {WINDOW_SPAN}
    device = [d for d in device if d[0] not in spans]
    if window is None:
        raise RuntimeError("trace: no window span recorded")
    if not device:
        raise RuntimeError("trace: the profiler recorded no device work")
    host.sort(key=lambda x: x[1])
    return Trace(t0=window[0], t1=window[1], device=device, host=host,
                 info=info, peak=peak)
