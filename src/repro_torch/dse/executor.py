"""Sweep executor: group -> cached batched run on the card -> stats (the
port's counterpart of ``repro.dse.executor``).

The executor turns an expanded `SweepSpec` into as few runs as possible:

  1. group the `RunPoint`s by *compile group* — everything that changes
     the run: (system, controller config, frontend config, n_cycles,
     channels).  Load knobs (interval, read ratio) are the run's
     `FrontParams`, so the whole load grid of a group is one run;
  2. fetch the group's run from the engine's process-wide `RUN_CACHE`
     (`repro_torch.core.engine.RunCache`): identical groups across sweeps
     or repeated `execute` calls build nothing, and a warm entry sends
     nothing to the card again (its DynParams, frontend tables and kernel
     plans stay there);
  3. run the group's P load points as the design points of that one run:
     every loop iteration makes one launch of the fused controller-step
     kernel per spec group over all the group's (point x channel) lanes,
     and one host sync;
  4. fold the group's stats into the `SweepResult` columns.

A group's loop synchronises with the card every iteration, so a group is
finished when its run returns: ``max_in_flight`` keeps the reference's
meaning as a bound on the groups whose results are live at once (at
least 1), and it is always met, with one.  A
`repro_torch.telemetry.Profiler` attributes the wall clock to
``dispatch`` (a group's whole run, its first-call setup included) and
``collect`` (the host fold) spans, reported in ``meta["profile"]``.

With `SweepSpec(capture_traces=...)` each group runs its trace-recording
entry instead — still one cache entry per group — one point at a time
(a trace records one point's run), and each point's dense trace is
compacted into a `repro_torch.trace.CommandTrace` with the reference's
metadata, optionally persisted as one `.npz` artifact per point.
`SweepSpec(telemetry=W)` works the same way for the windowed run: every
point gains a `repro_torch.telemetry.Telemetry`.  `meta["cache"]` reports
the public `RunCache.stats()` accounting.

``execute(devices=[d0, d1, ...])`` splits each group's point batch over
the listed devices (the reference's ``_shard_batch``): the batch is padded
by repeating its last point until it divides by the device count, device
``i`` runs the ``i``-th contiguous share through its own cache entry,
and the padding is dropped from the results (``meta["padded_points"]``).
A device may be listed more than once (``["cpu"] * 4``, ``["cuda:0",
"cuda:0"]``).  The shares run one after another, each its own
host-driven loop: a split adds room on a second card, not speed.  Host
threads would not overlap them: ``chip_smoke.py`` phase 23 runs two
one-device sweeps in two threads on one card, and they take longer than
one after another (each loop's Python holds the GIL), so concurrent
shares wait for a process per card (ROADMAP).  A capturing group's
one-point runs go round-robin over the devices.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch import _device
from repro_torch.convert import stats_to_numpy
from repro_torch.core import engine as E
from repro_torch.core import frontend as F
from repro_torch.core.compile import as_system, compile_spec, compile_system
from repro_torch.dse import results as R
from repro_torch.dse.spec import Composition, SweepSpec


def lint_sweep_systems(points) -> None:
    """Pre-run spec-lint gate of a sweep: run the spec linter over every
    distinct override-carrying system (plain or inside a composition) and
    raise :class:`repro_torch.analysis.SpecLintError` with the merged
    report if any has error-severity findings.  Systems without overrides
    are skipped: the registered standards lint clean."""
    from repro_torch.analysis.report import merge
    from repro_torch.analysis.speclint import SpecLintError, lint_spec
    seen: set = set()
    bad = []
    for pt in points:
        if isinstance(pt.system, Composition):
            members = [(g.system, g.channels) for g in pt.system.groups]
        else:
            members = [(pt.system, pt.n_channels)]
        for sy, ch in members:
            if not sy.timing_overrides or (sy, ch) in seen:
                continue
            seen.add((sy, ch))
            rep = lint_spec(sy.standard, sy.org_preset, sy.timing_preset,
                            sy.overrides_dict, channels=ch)
            if not rep.ok():
                bad.append(rep)
    if bad:
        raise SpecLintError(merge(bad, target="sweep-pre-lint"))


def _compile_point_system(pt):
    """A RunPoint's memory system: a plain `System` becomes its 1-group
    CompiledSpec, a `Composition` a MemorySystemSpec."""
    if isinstance(pt.system, Composition):
        return compile_system([
            dict(standard=g.system.standard, org_preset=g.system.org_preset,
                 timing_preset=g.system.timing_preset,
                 timing_overrides=g.system.overrides_dict,
                 channels=g.channels, link_latency=g.link_latency)
            for g in pt.system.groups])
    return compile_spec(pt.system.standard, pt.system.org_preset,
                        pt.system.timing_preset, pt.system.overrides_dict,
                        channels=pt.n_channels)


def compile_group_key(pt) -> tuple:
    """Hashable key of the run a point belongs to.  The channel count and
    the mapper order (inside the frontend freeze) both change the run, so
    they split compile groups."""
    return (pt.system, E._freeze(pt.controller), E._freeze(pt.frontend),
            pt.n_cycles, pt.n_channels)


def group_points(points) -> dict:
    """Group (index, point) pairs by compile group, preserving order."""
    groups: dict = {}
    for i, pt in enumerate(points):
        groups.setdefault(compile_group_key(pt), []).append((i, pt))
    return groups


def _front_params(pts, fcfg, device) -> F.FrontParams:
    """The group's load points as the run's ``(P,)`` `FrontParams`."""
    return F.stack_params([(pt.interval, pt.read_ratio) for pt in pts],
                          fcfg.probe_gap, device)


def _run_devices(devices) -> list:
    """The devices a sweep runs on: ``None`` = the card."""
    if devices is None:
        return [_device.resolve(None)]
    devices = list(devices)
    if not devices:
        raise ValueError("devices=[] — pass devices=None for the card or "
                         "a device list such as ['cpu']")
    return [_device.resolve(d) for d in devices]


def _shares(members: list, n_devices: int) -> tuple:
    """``members`` padded by repeating the last until the count divides by
    ``n_devices``, cut into ``n_devices`` contiguous shares: ``(shares,
    padding)``."""
    pad = (-len(members)) % n_devices
    padded = members + [members[-1]] * pad
    k = len(padded) // n_devices
    return [padded[i * k:(i + 1) * k] for i in range(n_devices)], pad


def _first_points(stats, k: int):
    """The first ``k`` points of batched numpy stats."""
    if isinstance(stats, tuple):
        vals = [_first_points(x, k) for x in stats]
        return type(stats)(*vals) if hasattr(stats, "_fields") else \
            tuple(vals)
    return stats[:k]


def execute(spec: SweepSpec, cache: E.RunCache | None = None,
            devices=None, max_in_flight: int = 2,
            profiler=None) -> R.SweepResult:
    """Run every point of `spec`, one cached batched run per compile
    group (see the module docstring), and return the columns, curves and
    accounting as a `SweepResult`.

    `cache` defaults to the engine's process-wide `RUN_CACHE`; pass a
    fresh `RunCache()` to isolate builds (tests do).  `devices` is None
    (the card) or a device list (``["cpu"]`` for the tests; several
    split each group's points, see the module notes).
    `max_in_flight` bounds the groups whose results are live at once
    (>= 1; each group's run finishes before the next starts, so one is).
    `profiler` is an optional `repro_torch.telemetry.Profiler` to fold
    the dispatch/collect spans into (one is made per call otherwise,
    reported in ``meta["profile"]``)."""
    from repro_torch import telemetry as T
    from repro_torch.trace.capture import capture as capture_trace
    from repro_torch.trace.format import save as save_trace
    if int(max_in_flight) < 1:
        raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
    cache = E.RUN_CACHE if cache is None else cache
    devices = _run_devices(devices)
    device = devices[0]
    prof = profiler if profiler is not None else T.Profiler(cache)
    points = spec.expand()
    if spec.lint_specs:
        lint_sweep_systems(points)      # fail fast with a LintReport
    groups = group_points(points)

    n = len(points)
    cols = {k: np.zeros((n,), np.float64)
            for k in ("throughput_gbps", "latency_ns", "peak_gbps")}
    ints = {k: np.zeros((n,), np.int64)
            for k in ("reads_done", "writes_done", "probe_cnt", "deferred",
                      "cycles", "scan_steps", "skipped_cycles")}
    cmd_counts: list = [None] * n
    cmd_names: list = [None] * n
    capture = spec.capture_traces
    traces: list | None = [None] * n if capture else None
    trace_dir = capture if isinstance(capture, str) else None
    trace_paths: dict = {}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    telemetry: list | None = [None] * n if spec.telemetry else None
    telem_paths: dict = {}
    if spec.telemetry_dir:
        os.makedirs(spec.telemetry_dir, exist_ok=True)

    t0 = time.perf_counter()
    misses0, hits0, trace0 = cache.misses, cache.hits, E.TRACE_COUNT
    group_meta = []
    host_syncs = 0
    padded_total = 0

    def fold(members, idx, msys, cspec, ccfg, fcfg, stats, dense, snaps):
        """Fold one run's batched stats (of the points ``members``) into
        the columns, with its traces and telemetry."""
        for j, (i, pt) in enumerate(members):
            if snaps is not None:
                telemetry[i] = T.build(msys, E._point_snaps(snaps, j),
                                       window=spec.telemetry,
                                       n_cycles=pt.n_cycles)
                telemetry[i].meta["point"] = pt.label
                if spec.telemetry_dir:
                    telem_paths[i] = T.save(
                        telemetry[i], os.path.join(
                            spec.telemetry_dir, f"point_{i:04d}.npz"))
            if dense is not None:
                tr = capture_trace(
                    cspec, dense, controller=ccfg, frontend=fcfg,
                    interval=pt.interval, read_ratio=pt.read_ratio,
                    seed=spec.seed, point_index=i, label=pt.label)
                traces[i] = tr
                if trace_dir:
                    trace_paths[i] = save_trace(
                        tr, os.path.join(trace_dir, f"point_{i:04d}.npz"))
            cmd_counts[i] = np.asarray(stats.cmd_counts[j])
            cmd_names[i] = list(msys.cmd_names)
        cols["throughput_gbps"][idx] = R.throughput_gbps_array(msys, stats)
        cols["latency_ns"][idx] = R.avg_probe_latency_ns_array(msys, stats)
        cols["peak_gbps"][idx] = E.peak_gbps(msys)
        for k in ints:
            ints[k][idx] = np.asarray(getattr(stats, k))

    def split(out):
        """A run's output -> (stats, dense trace, telemetry snapshots)."""
        out = out if isinstance(out, tuple) and not hasattr(
            out, "per_group") else (out,)
        stats, rest = stats_to_numpy(out[0]), list(out[1:])
        dense = rest.pop(0) if capture else None
        return stats, dense, (rest.pop(0) if spec.telemetry else None)

    for key, members in groups.items():
        td = time.perf_counter()
        idx = [i for i, _ in members]
        pts = [pt for _, pt in members]
        sy, ccfg, fcfg = pts[0].system, pts[0].controller, pts[0].frontend
        cspec = _compile_point_system(pts[0])
        msys = as_system(cspec)
        # (device, its points, how many of them are real) per run
        if capture:
            batches = [(devices[j % len(devices)], [m], 1)
                       for j, m in enumerate(members)]
            pad = 0
        else:
            shares, pad = _shares(members, len(devices))
            real = [max(0, min(len(sh), len(members) - j * len(sh)))
                    for j, sh in enumerate(shares)]
            batches = list(zip(devices, shares, real))
        padded_total += pad
        runs = {}                       # one cache lookup per device
        for dev in dict.fromkeys(dev for dev, _, _ in batches):
            runs[dev] = cache.get(cspec, ccfg, fcfg, pts[0].n_cycles,
                                  trace=bool(capture), batched=True,
                                  telemetry=spec.telemetry, device=dev)
        results = [runs[dev](_front_params([pt for _, pt in b], fcfg, dev),
                             spec.seed) for dev, b, _ in batches]
        dt = time.perf_counter() - td
        prof.add("dispatch", dt)
        iterations = sum(r.host_syncs for r in results)
        host_syncs += iterations
        tc = time.perf_counter()
        for (_, b, k), r in zip(batches, results):
            if not k:
                continue
            stats, dense, snaps = split(r.out)
            fold(b[:k], [i for i, _ in b[:k]], msys, cspec, ccfg, fcfg,
                 _first_points(stats, k), dense, snaps)
        dc = time.perf_counter() - tc
        prof.add("collect", dc)
        group_meta.append({
            "system": sy.label, "n_points": len(pts),
            "n_channels": pts[0].n_channels, "n_spec_groups": msys.n_groups,
            "mapper": fcfg.mapper, "padded": pad, "iterations": iterations,
            "dispatch_s": round(dt, 3), "collect_s": round(dc, 3),
            "wall_s": round(dt + dc, 3)})

    meta = {
        "n_points": n,
        "n_groups": len(groups),
        "n_devices": len(devices),
        "device": str(device),
        "compile_cache_misses": cache.misses - misses0,
        "compile_cache_hits": cache.hits - hits0,
        "traces": E.TRACE_COUNT - trace0,
        "wall_s": round(time.perf_counter() - t0, 3),
        "groups": group_meta,
        "seed": spec.seed,
        "padded_points": padded_total,
        "max_in_flight": int(max_in_flight),
        # loop iterations of every group's run, one host sync each
        "host_syncs": host_syncs,
        "profile": {
            **prof.report(),
            "fast_forward": {
                "scan_steps": int(ints["scan_steps"].sum()),
                "skipped_cycles": int(ints["skipped_cycles"].sum()),
                "idle_fraction": round(
                    float(ints["skipped_cycles"].sum())
                    / max(float(ints["cycles"].sum()), 1.0), 4),
            },
        },
        "cache": cache.stats(),
    }
    if trace_paths:
        meta["trace_artifacts"] = [trace_paths.get(i) for i in range(n)]
    if telem_paths:
        meta["telemetry_artifacts"] = [telem_paths.get(i) for i in range(n)]
    return R.SweepResult(points=points, cmd_counts=cmd_counts,
                         cmd_names=cmd_names, meta=meta, traces=traces,
                         telemetry=telemetry, **cols, **ints)
