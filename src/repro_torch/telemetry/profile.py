"""Host-side run profiler: where the wall clock goes around the port's
runs — the first call of each cached run (DynParams upload, the kernel's
build at first use, one run), :class:`repro_torch.core.engine.RunCache`
hits and misses, and warm-run throughput (cycles per second).  The port's
copy of ``repro.telemetry.profile``.

- :class:`Profiler` records named spans and cache-accounting deltas for
  any host code (DSE sweeps, benchmarks).
- :func:`profile_run` characterizes one run configuration of a
  :class:`~repro_torch.core.Simulator`, cold and warm.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.core import engine as E
from repro_torch.telemetry import spans


class Profiler:
    """Record named wall-time spans and RunCache accounting deltas.

    >>> prof = Profiler()
    >>> with prof.span("sweep"):
    ...     result = execute(spec)
    >>> prof.report()["spans"]["sweep"]        # {"s": ..., "calls": 1}
    >>> prof.report()["cache"]                 # hits/misses since built

    Spans nest and repeat (times accumulate per name).  Under
    ``torch.profiler`` a span is also a span of
    :mod:`repro_torch.telemetry.spans`, so it shows in the torch trace.
    The cache view is
    a delta against the profiler's construction, so a warm process-wide
    :data:`repro_torch.core.engine.RUN_CACHE` does not pollute it."""

    def __init__(self, cache: E.RunCache | None = None):
        self.cache = cache if cache is not None else E.RUN_CACHE
        self._base = dict(self.cache.stats())
        self._spans: dict = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with spans.span(name):
                yield self
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Fold an externally timed interval into span ``name`` (the sweep
        executor's per-group dispatch and collect)."""
        s = self._spans.setdefault(name, {"s": 0.0, "calls": 0})
        s["s"] += float(seconds)
        s["calls"] += 1

    def cache_stats(self) -> dict:
        """RunCache accounting since construction: the counters as deltas,
        the device and topology views as they are."""
        delta_keys = {"entries", "hits", "misses", "first_call_s"}
        out = {}
        for k, v in self.cache.stats().items():
            if k in delta_keys and isinstance(v, (int, float)):
                base = self._base.get(k, 0)
                out[k] = round(v - base, 3) if isinstance(v, float) \
                    else v - base
            else:
                out[k] = v
        return out

    def report(self) -> dict:
        return {"wall_s": round(time.perf_counter() - self._t0, 3),
                "spans": {k: {"s": round(v["s"], 3), "calls": v["calls"]}
                          for k, v in self._spans.items()},
                "cache": self.cache_stats()}

    def summary(self) -> str:
        r = self.report()
        c = r["cache"]
        lines = [f"wall {r['wall_s']:.3f}s | cache: {c['entries']:+d} "
                 f"programs, {c['hits']} hits / {c['misses']} misses, "
                 f"first-call (trace+compile+run) {c['first_call_s']:.3f}s"]
        for name, s in sorted(r["spans"].items(), key=lambda kv: -kv[1]["s"]):
            lines.append(f"  {name:<24} {s['s']:>9.3f}s x{s['calls']}")
        return "\n".join(lines)


def _sync(sim) -> None:
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def profile_run(sim, n_cycles: int, repeats: int = 3, **run_kw) -> dict:
    """Cold/warm characterization of one run configuration: the first
    call and the best of ``repeats`` warm calls, each synchronized with
    the device.  Returns ``first_call_s``, ``warm_s``, ``compile_s``
    (first - warm), ``cycles_per_sec`` (warm), the fast-forward
    accounting (``scan_steps``, ``skipped_cycles``, ``idle_fraction``)
    and the RunCache delta.  ``run_kw`` goes to ``sim.run``."""
    prof = Profiler()
    with prof.span("first_call"):
        out = sim.run(n_cycles, **run_kw)
        _sync(sim)
    warm = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = sim.run(n_cycles, **run_kw)
        _sync(sim)
        warm.append(time.perf_counter() - t0)
    r = prof.report()
    first = r["spans"]["first_call"]["s"]
    best = min(warm)
    stats = out[0] if isinstance(out, tuple) and not hasattr(
        out, "to_dict") else out
    skipped = int(stats.skipped_cycles)
    return {"first_call_s": round(first, 4), "warm_s": round(best, 4),
            "compile_s": round(max(first - best, 0.0), 4),
            "cycles_per_sec": round(n_cycles / best, 1) if best else None,
            "scan_steps": int(stats.scan_steps),
            "skipped_cycles": skipped,
            "idle_fraction": round(skipped / n_cycles, 4) if n_cycles
            else 0.0,
            "cache": r["cache"]}
