"""Windowed time-series telemetry of the port's runs: the metrics layer
between end-of-run ``Stats`` and full per-cycle command traces (the
port's own copy of ``repro.telemetry.core``, numpy only).

``Simulator.run(..., telemetry=W)`` copies every spec group's *cumulative*
counters at each multiple of ``W`` into a device buffer (read back once
after the run); :func:`build` diffs consecutive snapshots on the host into
per-window counters, which therefore sum back to the end-of-run ``Stats``
exactly (the last snapshot IS the final total).  The final window is
ragged when ``n_cycles % W != 0``; rate metrics divide by each window's
true width.

Metric definitions (per window, per channel):

- ``reads``/``writes``: requests whose data burst finished in the window.
- bandwidth: ``(reads + writes) * access_bytes / (width * tCK)`` on the
  owning group's own clock.
- ``occ_sum``: cycle-sum of occupied request-queue slots; average queue
  occupancy is ``occ_sum / width``.
- row-hit rate: ``1 - ACT / (RD + WR)`` from the windowed command counts.
- ``lat_hist``: served-probe latency histogram over bucket edges planned
  at spec-compile time (``CompiledSpec.lat_bucket_edges``, in cycles).
- refresh activity: windowed count of ``REF*`` commands.
- ``issued``/``deferred``: commands issued / predicate-deferred
  candidates per window.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.compile import as_system

FORMAT_VERSION = 1


def _host(a) -> np.ndarray:
    """A counter as a numpy array: the port's ``Stats`` hold tensors on the
    run's device."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _diff(a: np.ndarray) -> np.ndarray:
    """Cumulative snapshots -> per-window deltas along axis 0."""
    return np.diff(a, axis=0, prepend=np.zeros((1,) + a.shape[1:], a.dtype))


@dataclasses.dataclass
class GroupTelemetry:
    """Per-window counters of ONE spec group.  Every counter array has a
    leading ``(n_windows, C)`` shape (``C`` = the group's channel count);
    ``cmd_counts`` / ``lat_hist`` append the command / bucket axis."""
    standard: str
    channels: int
    link_latency: int
    tCK_ps: int
    access_bytes: int
    cmd_names: list
    lat_edges: tuple                # bucket upper edges, cycles
    reads: np.ndarray               # (W, C)
    writes: np.ndarray
    probe_lat_sum: np.ndarray
    probe_cnt: np.ndarray
    data_bus_busy: np.ndarray
    deferred: np.ndarray
    occ_sum: np.ndarray
    cmd_counts: np.ndarray          # (W, C, n_cmds) native namespace
    lat_hist: np.ndarray            # (W, C, n_buckets)

    # -- derived rates (given the owning Telemetry's window widths) -------
    def bandwidth_gbps(self, widths: np.ndarray) -> np.ndarray:
        """(W, C) achieved GB/s per window on this group's own clock."""
        seconds = widths[:, None] * self.tCK_ps * 1e-12
        moved = (self.reads + self.writes) * self.access_bytes
        return np.divide(moved, seconds * 1e9, out=np.zeros_like(moved,
                         float), where=seconds > 0)

    def occupancy(self, widths: np.ndarray) -> np.ndarray:
        """(W, C) mean occupied request-queue slots per window."""
        return np.divide(self.occ_sum, widths[:, None],
                         out=np.zeros_like(self.occ_sum, float),
                         where=widths[:, None] > 0)

    def _count(self, pred) -> np.ndarray:
        ids = [i for i, n in enumerate(self.cmd_names) if pred(n)]
        return self.cmd_counts[:, :, ids].sum(axis=2)

    def row_hit_rate(self) -> np.ndarray:
        """(W, C) ``1 - ACT/(RD+WR)`` per window; NaN where no data cmd."""
        act = self._count(lambda n: n.startswith("ACT")).astype(float)
        data = self._count(
            lambda n: n in ("RD", "WR", "RDA", "WRA")).astype(float)
        return np.where(data > 0, 1.0 - act / np.maximum(data, 1), np.nan)

    def refreshes(self) -> np.ndarray:
        """(W, C) refresh commands (``REF*``) per window."""
        return self._count(lambda n: n.startswith("REF"))

    def issued(self) -> np.ndarray:
        """(W, C) total commands issued per window."""
        return self.cmd_counts.sum(axis=2)


@dataclasses.dataclass
class Telemetry:
    """One run's windowed time series: group-indexed counters plus the
    shared window geometry (``t_end`` is each window's exclusive end
    cycle; the final window is ragged when ``n_cycles % window != 0``)."""
    window: int
    n_cycles: int
    t_end: np.ndarray               # (W,) exclusive end cycle
    groups: tuple                   # GroupTelemetry per spec group
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_windows(self) -> int:
        return len(self.t_end)

    @property
    def widths(self) -> np.ndarray:
        return _diff(self.t_end)

    @property
    def t_start(self) -> np.ndarray:
        return self.t_end - self.widths

    def __len__(self):
        return self.n_windows

    # -- consistency ------------------------------------------------------
    def check(self, stats) -> None:
        """Assert bit-consistency against the same run's end-of-run
        ``Stats`` (tensors on any device, or numpy): every windowed
        counter, summed over all windows, must EQUAL the aggregate (and the
        latency histogram must account for every served probe).  Raises
        ``ValueError`` on any mismatch."""
        errs = []
        for g, gt in enumerate(self.groups):
            ch = stats.per_group[g]
            pairs = [("reads", gt.reads, ch.reads_done),
                     ("writes", gt.writes, ch.writes_done),
                     ("probe_lat_sum", gt.probe_lat_sum, ch.probe_lat_sum),
                     ("probe_cnt", gt.probe_cnt, ch.probe_cnt),
                     ("data_bus_busy", gt.data_bus_busy, ch.data_bus_busy),
                     ("deferred", gt.deferred, ch.deferred),
                     ("cmd_counts", gt.cmd_counts, ch.cmd_counts)]
            for name, win, agg in pairs:
                tot = win.sum(axis=0)
                if not np.array_equal(tot, _host(agg)):
                    errs.append(f"group {g} {name}: sum-over-windows "
                                f"{tot.tolist()} != aggregate "
                                f"{_host(agg).tolist()}")
            hist = gt.lat_hist.sum(axis=(0, 2))
            if not np.array_equal(hist, _host(ch.probe_cnt)):
                errs.append(f"group {g} lat_hist accounts for "
                            f"{hist.tolist()} probes but probe_cnt is "
                            f"{_host(ch.probe_cnt).tolist()}")
            if (gt.lat_hist < 0).any():
                # a negative bucket means the engine's cumulative
                # histogram disagrees with probe_cnt (unpack bug)
                errs.append(f"group {g} lat_hist has negative buckets")
        if errs:
            raise ValueError("windowed telemetry inconsistent with Stats:\n"
                             + "\n".join("  " + e for e in errs))

    # -- presentation -----------------------------------------------------
    def summary(self) -> str:
        """Per-group min/mean/max of the windowed rates."""
        lines = [f"{self.n_windows} windows of {self.window} cycles over "
                 f"{self.n_cycles:,} cycles"
                 + (" (ragged tail)" if self.n_cycles % self.window else "")]
        w = self.widths
        for g, gt in enumerate(self.groups):
            bw = gt.bandwidth_gbps(w).sum(axis=1)     # system GB/s of group
            occ = gt.occupancy(w).mean(axis=1)
            hit = gt.row_hit_rate()
            hit = hit[~np.isnan(hit)]
            lines.append(
                f"group {g} [{gt.standard} x{gt.channels}"
                + (f" link={gt.link_latency}" if gt.link_latency else "")
                + f"]: bw GB/s min/mean/max "
                f"{bw.min():.2f}/{bw.mean():.2f}/{bw.max():.2f}, "
                f"queue occ {occ.mean():.1f}, row-hit "
                + (f"{hit.mean():.1%}" if hit.size else "n/a")
                + f", refreshes {int(gt.refreshes().sum())}, "
                f"deferred {int(gt.deferred.sum())}")
        return "\n".join(lines)


def build(spec, snaps, window: int, n_cycles: int) -> Telemetry:
    """Convert one run's cumulative ``GroupWindowSnap`` tuple (one per spec
    group, numpy leaves ``(n_windows, C, ...)``) into a
    :class:`Telemetry` of per-window counters.  ``spec`` is the run's CompiledSpec or
    MemorySystemSpec — the source of clocks, namespaces, and bucket
    edges."""
    msys = as_system(spec)
    if len(snaps) != msys.n_groups:
        raise ValueError(f"snapshot tuple has {len(snaps)} groups but the "
                         f"system has {msys.n_groups}")
    n_full, rem = divmod(int(n_cycles), int(window))
    t_end = [window * (i + 1) for i in range(n_full)]
    if rem or not t_end:
        t_end.append(int(n_cycles))
    t_end = np.asarray(t_end, np.int64)
    groups = []
    for grp, snap in zip(msys.groups, snaps):
        ch = snap.ch
        if len(np.asarray(ch.reads_done)) != len(t_end):
            raise ValueError(
                f"snapshot has {len(np.asarray(ch.reads_done))} windows, "
                f"expected {len(t_end)} for n_cycles={n_cycles} "
                f"window={window}")
        d = lambda a: _diff(np.asarray(a))
        # unpack the engine's fused gauge array (W, C, 1 + n_edges):
        # column 0 is the occupancy cycle-sum, the rest a CUMULATIVE
        # latency histogram (count of probes with latency <= edge_k) —
        # diff along the bucket axis recovers the buckets, probe_cnt
        # closes the open top bucket
        tm = d(snap.tm)
        probe_cnt = d(ch.probe_cnt)
        cum = tm[:, :, 1:]
        lat_hist = np.concatenate(
            [cum[:, :, :1], np.diff(cum, axis=2),
             (probe_cnt - cum[:, :, -1])[:, :, None]], axis=2)
        groups.append(GroupTelemetry(
            standard=grp.cspec.standard or grp.cspec.name,
            channels=grp.channels, link_latency=grp.link_latency,
            tCK_ps=grp.cspec.tCK_ps, access_bytes=grp.cspec.access_bytes,
            cmd_names=list(grp.cspec.cmd_names),
            lat_edges=tuple(grp.cspec.lat_bucket_edges),
            reads=d(ch.reads_done), writes=d(ch.writes_done),
            probe_lat_sum=d(ch.probe_lat_sum), probe_cnt=probe_cnt,
            data_bus_busy=d(ch.data_bus_busy), deferred=d(ch.deferred),
            occ_sum=tm[:, :, 0], cmd_counts=d(ch.cmd_counts),
            lat_hist=lat_hist))
    return Telemetry(window=int(window), n_cycles=int(n_cycles),
                     t_end=t_end, groups=tuple(groups),
                     meta={"label": msys.label})


# --------------------------------------------------------------------------
# Artifacts: columnar .npz + JSON Lines
# --------------------------------------------------------------------------

_ARRAYS = ("reads", "writes", "probe_lat_sum", "probe_cnt",
           "data_bus_busy", "deferred", "occ_sum", "cmd_counts", "lat_hist")


def save(telem: Telemetry, path: str) -> str:
    """Write one ``.npz`` artifact: the shared window geometry, every
    group's counter arrays (``g{i}:{name}`` keys), and a JSON meta
    header."""
    cols = {"t_end": telem.t_end}
    gmeta = []
    for gi, gt in enumerate(telem.groups):
        for name in _ARRAYS:
            cols[f"g{gi}:{name}"] = getattr(gt, name)
        gmeta.append({"standard": gt.standard, "channels": gt.channels,
                      "link_latency": gt.link_latency, "tCK_ps": gt.tCK_ps,
                      "access_bytes": gt.access_bytes,
                      "cmd_names": gt.cmd_names,
                      "lat_edges": list(gt.lat_edges)})
    meta = {"format": FORMAT_VERSION, "window": telem.window,
            "n_cycles": telem.n_cycles, "groups": gmeta, **telem.meta}
    cols["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **cols)
    return path


def load(path: str) -> Telemetry:
    """Load a :func:`save` artifact back into a :class:`Telemetry`."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("format", 0) > FORMAT_VERSION:
            raise ValueError(f"{path}: telemetry format "
                             f"{meta['format']} is newer than this reader "
                             f"({FORMAT_VERSION})")
        groups = []
        for gi, gm in enumerate(meta.pop("groups")):
            arrs = {name: z[f"g{gi}:{name}"] for name in _ARRAYS}
            groups.append(GroupTelemetry(
                standard=gm["standard"], channels=gm["channels"],
                link_latency=gm["link_latency"], tCK_ps=gm["tCK_ps"],
                access_bytes=gm["access_bytes"],
                cmd_names=list(gm["cmd_names"]),
                lat_edges=tuple(gm["lat_edges"]), **arrs))
        t_end = z["t_end"]
    extra = {k: v for k, v in meta.items()
             if k not in ("format", "window", "n_cycles")}
    return Telemetry(window=meta["window"], n_cycles=meta["n_cycles"],
                     t_end=t_end, groups=tuple(groups), meta=extra)


def write_jsonl(telem: Telemetry, path: str) -> int:
    """Stream one JSON record per window (per-channel lists inside), for
    log pipelines / pandas.  Returns the record count."""
    widths = telem.widths
    with open(path, "w") as f:
        for i in range(telem.n_windows):
            rec = {"window": i, "t_start": int(telem.t_start[i]),
                   "t_end": int(telem.t_end[i]), "groups": []}
            for gt in telem.groups:
                hit = gt.row_hit_rate()[i]
                rec["groups"].append({
                    "standard": gt.standard,
                    "reads": gt.reads[i].tolist(),
                    "writes": gt.writes[i].tolist(),
                    "gbps": [round(x, 4) for x in
                             gt.bandwidth_gbps(widths)[i]],
                    "queue_occ": [round(x, 3) for x in
                                  gt.occupancy(widths)[i]],
                    "row_hit": [None if np.isnan(x) else round(x, 4)
                                for x in hit],
                    "refreshes": gt.refreshes()[i].tolist(),
                    "deferred": gt.deferred[i].tolist(),
                    "lat_hist": gt.lat_hist[i].tolist(),
                })
            f.write(json.dumps(rec) + "\n")
    return telem.n_windows
