"""Sweep result post-processing: latency-throughput curves + persistence
(the port's copy of ``repro.dse.results``).

The engine's scalar metric helpers (`repro_torch.core.engine.
throughput_gbps` et al.) read one run's stats; the `*_array` functions
here are their vectorized numpy equivalents over the batched stats of a
sweep.  `SweepResult` holds one row per `RunPoint` in columnar numpy
form, extracts latency-throughput curves (with knee detection) per
(system, controller, read-ratio) series, and persists to the reference's
`.npz` + `.json` artifact pair, so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core import controller as C
from repro_torch.core import frontend as F
from repro_torch.core.compile import as_system
from repro_torch.core.engine import _check_system_stats, _freeze, _np
from repro_torch.dse.spec import Composition, RunPoint, System, SystemGroup
from repro_torch.trace.capture import config_doc

# --------------------------------------------------------------------------
# Vectorized derived metrics (batched counterparts of the engine's)
# --------------------------------------------------------------------------


def _f64(a) -> np.ndarray:
    """A counter (numpy array or a tensor on any device) as float64."""
    return np.asarray(_np(a), np.float64)


def throughput_gbps_array(spec, stats) -> np.ndarray:
    """Achieved GB/s per batched point; works on (B,) or scalar stats.

    ``spec`` may be a CompiledSpec or a MemorySystemSpec — heterogeneous
    systems aggregate each group's bytes on that group's own clock
    (group-correct, never one spec's bandwidth times total channels)."""
    msys = as_system(spec)
    _check_system_stats(msys, stats)
    total = None
    for grp, ch in zip(msys.groups, stats.per_group):
        moved = (_f64(ch.reads_done).sum(axis=-1)
                 + _f64(ch.writes_done).sum(axis=-1)) \
            * grp.cspec.access_bytes
        seconds = _f64(stats.cycles) * grp.cspec.tCK_ps * 1e-12
        tp = np.divide(moved / 1e9, seconds,
                       out=np.zeros_like(moved), where=seconds > 0)
        total = tp if total is None else total + tp
    return total


def avg_probe_latency_ns_array(spec, stats) -> np.ndarray:
    """Mean probe latency in ns per batched point; NaN where no probe
    finished.  Probe latencies count on the system's shared cycle index
    and convert with the reference clock (group 0's tCK)."""
    cnt = _f64(stats.probe_cnt)
    lat_sum = _f64(stats.probe_lat_sum)
    cycles = np.divide(lat_sum, cnt, out=np.full_like(lat_sum, np.nan),
                       where=cnt > 0)
    return cycles * as_system(spec).tCK_ps * 1e-3


def knee_index(latency_ns, knee_factor: float = 2.0) -> int:
    """Index of the curve's knee: the first point (ordered by increasing
    load) whose latency exceeds `knee_factor` x the low-load latency.
    Returns the last index when the curve never blows up."""
    lat = np.asarray(latency_ns, np.float64)
    finite = lat[np.isfinite(lat)]
    if len(finite) == 0:
        return len(lat) - 1
    base = finite[0]
    over = np.where(np.isfinite(lat) & (lat > knee_factor * base))[0]
    return int(over[0]) if len(over) else len(lat) - 1


@dataclasses.dataclass
class Curve:
    """One latency-throughput series at fixed (system, controller,
    read-ratio), ordered by increasing load (decreasing interval)."""
    system: str
    scheduler: str
    read_ratio: float
    intervals: np.ndarray       # (K,) decreasing — load rises along the row
    throughput_gbps: np.ndarray
    latency_ns: np.ndarray
    peak_gbps: float
    knee: int                   # index into the arrays
    n_channels: int = 1

    @property
    def peak_fraction(self) -> float:
        return float(self.throughput_gbps.max() / self.peak_gbps) \
            if self.peak_gbps else 0.0


@dataclasses.dataclass
class SweepResult:
    """Columnar results for every expanded `RunPoint` of one sweep."""
    points: list                        # list[RunPoint]
    throughput_gbps: np.ndarray         # (N,) GB/s
    latency_ns: np.ndarray              # (N,) mean probe latency
    peak_gbps: np.ndarray               # (N,) theoretical peak of the system
    reads_done: np.ndarray              # (N,)
    writes_done: np.ndarray             # (N,)
    probe_cnt: np.ndarray               # (N,)
    deferred: np.ndarray                # (N,)
    cycles: np.ndarray                  # (N,)
    scan_steps: np.ndarray              # (N,) scan-body executions
    skipped_cycles: np.ndarray          # (N,) fast-forwarded idle cycles
    cmd_counts: list                    # per-point (n_cmds,) arrays (ragged)
    cmd_names: list                     # per-point command-name lists
    meta: dict = dataclasses.field(default_factory=dict)
    #: Per-point `repro_torch.trace.CommandTrace` objects when the sweep ran with
    #: `capture_traces`; None otherwise.  Not persisted by `save`/`load` —
    #: trace artifacts are saved separately (one `.npz` per point, paths in
    #: `meta["trace_artifacts"]`) when `capture_traces` names a directory.
    traces: list | None = None
    #: Per-point `repro_torch.telemetry.Telemetry` when the sweep ran with
    #: `SweepSpec(telemetry=W)`; None otherwise.  Not persisted by
    #: `save`/`load` — telemetry artifacts are saved separately (one
    #: `.npz` per point, paths in `meta["telemetry_artifacts"]`) when
    #: `telemetry_dir` names a directory.
    telemetry: list | None = None

    def __len__(self):
        return len(self.points)

    # -- curve extraction -------------------------------------------------
    def curves(self, knee_factor: float = 2.0) -> list:
        """Latency-throughput curves per (system, controller, read-ratio)."""
        series: dict = {}
        for i, pt in enumerate(self.points):
            # key on the FULL controller config (frozen) — two controllers
            # sharing a scheduler name are still distinct series — plus the
            # channel count and mapper order (distinct memory systems)
            key = (pt.system, _freeze(pt.controller), pt.n_channels,
                   pt.mapper, pt.read_ratio)
            series.setdefault(key, []).append(i)
        out = []
        for (sy, _ckey, nch, _mp, rr), idx in series.items():
            sched = self.points[idx[0]].controller.scheduler
            idx = sorted(idx, key=lambda i: -self.points[i].interval)
            lat = self.latency_ns[idx]
            out.append(Curve(
                system=sy.label, scheduler=sched, read_ratio=rr,
                intervals=np.array([self.points[i].interval for i in idx]),
                throughput_gbps=self.throughput_gbps[idx],
                latency_ns=lat,
                peak_gbps=float(self.peak_gbps[idx[0]]),
                knee=knee_index(lat, knee_factor),
                n_channels=nch))
        return out

    def cmd_count(self, i: int, name: str) -> int:
        """Per-point issued count of one command (0 if the standard lacks
        it)."""
        names = self.cmd_names[i]
        return int(self.cmd_counts[i][names.index(name)]) \
            if name in names else 0

    # -- pretty-printing --------------------------------------------------
    def to_table(self) -> str:
        hdr = (f"{'system':>10} {'ch':>3} {'sched':>7} {'interval':>9} "
               f"{'rd%':>5} {'GB/s':>8} {'peak%':>6} {'lat ns':>8}")
        rows = [hdr]
        for i, pt in enumerate(self.points):
            pk = self.peak_gbps[i]
            frac = 100 * self.throughput_gbps[i] / pk if pk else 0.0
            rows.append(
                f"{pt.system.label:>10} {pt.n_channels:>3} "
                f"{pt.controller.scheduler:>7} "
                f"{pt.interval:9.1f} {int(pt.read_ratio * 100):5d} "
                f"{self.throughput_gbps[i]:8.2f} {frac:6.1f} "
                f"{self.latency_ns[i]:8.1f}")
        return "\n".join(rows)

    # -- persistence ------------------------------------------------------
    _COLUMNS = ("throughput_gbps", "latency_ns", "peak_gbps", "reads_done",
                "writes_done", "probe_cnt", "deferred", "cycles",
                "scan_steps", "skipped_cycles")

    def save(self, path: str) -> str:
        """Persist to `<path>.npz` (columnar arrays) + `<path>.json`
        (points, command names, meta).  Returns the npz path."""
        base = path[:-4] if path.endswith(".npz") else path
        d = os.path.dirname(base)
        if d:
            os.makedirs(d, exist_ok=True)
        maxc = max((len(c) for c in self.cmd_counts), default=0)
        padded = np.full((len(self.points), maxc), -1, np.int64)
        for i, c in enumerate(self.cmd_counts):
            padded[i, :len(c)] = c
        arrays = {k: np.asarray(getattr(self, k)) for k in self._COLUMNS}
        np.savez(base + ".npz", cmd_counts=padded, **arrays)
        doc = {
            "points": [_point_doc(pt) for pt in self.points],
            "cmd_names": self.cmd_names,
            "meta": self.meta,
        }
        with open(base + ".json", "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return base + ".npz"

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        base = path[:-4] if path.endswith(".npz") else path
        with np.load(base + ".npz") as z:
            arrays = {k: z[k] for k in cls._COLUMNS if k in z}
            padded = z["cmd_counts"]
        # artifacts predating fast-forward: every cycle was a scan step
        arrays.setdefault("scan_steps", np.array(arrays["cycles"]))
        arrays.setdefault("skipped_cycles",
                          np.zeros_like(np.asarray(arrays["cycles"])))
        with open(base + ".json") as f:
            doc = json.load(f)
        points = [_point_from_doc(p) for p in doc["points"]]
        cmd_names = doc["cmd_names"]
        cmd_counts = [padded[i][padded[i] >= 0] for i in range(len(points))]
        return cls(points=points, cmd_counts=cmd_counts,
                   cmd_names=cmd_names, meta=doc.get("meta", {}), **arrays)


def _point_doc(pt: RunPoint) -> dict:
    if isinstance(pt.system, Composition):
        sy_doc = {"composition": [
            {"standard": g.system.standard,
             "org_preset": g.system.org_preset,
             "timing_preset": g.system.timing_preset,
             "timing_overrides": list(g.system.timing_overrides),
             "channels": g.channels, "link_latency": g.link_latency}
            for g in pt.system.groups]}
    else:
        sy_doc = {
            "standard": pt.system.standard,
            "org_preset": pt.system.org_preset,
            "timing_preset": pt.system.timing_preset,
            "timing_overrides": list(pt.system.timing_overrides),
        }
    return {
        **sy_doc,
        "controller": config_doc(pt.controller),
        "frontend": config_doc(pt.frontend),
        "n_cycles": pt.n_cycles,
        "interval": pt.interval,
        "read_ratio": pt.read_ratio,
        "n_channels": pt.n_channels,
    }


def _point_from_doc(p: dict) -> RunPoint:
    if "composition" in p:
        sy = Composition(tuple(
            SystemGroup(System(g["standard"], g["org_preset"],
                               g["timing_preset"],
                               tuple(tuple(kv) for kv
                                     in g.get("timing_overrides", []))),
                        int(g.get("channels", 1)),
                        int(g.get("link_latency", 0)))
            for g in p["composition"]))
    else:
        sy = System(p["standard"], p["org_preset"], p["timing_preset"],
                    tuple(tuple(kv) for kv in p.get("timing_overrides", [])))
    return RunPoint(system=sy,
                    controller=C.ControllerConfig(**p.get("controller", {})),
                    frontend=F.FrontendConfig(**p.get("frontend", {})),
                    n_cycles=p["n_cycles"], interval=p["interval"],
                    read_ratio=p["read_ratio"],
                    n_channels=p.get("n_channels", 1))
