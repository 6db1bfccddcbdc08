"""Cycle-level memory-system engine.

The counterpart of ``repro.core.engine``: it composes (frontend ->
address mapper -> controllers -> devices) into one cycle function and
runs it for ``n_cycles``.  All simulation state lives on the run's
device.  A memory system is one or more spec groups (``Simulator(...,
channels=N)`` is the 1-group case, ``Simulator(system=...)`` the general
one); group ``g`` has ``C_g`` channels behind an optional CXL-style link.
A run steps a batch of ``P`` design points (load points; ``P = 1`` for
``Simulator.run``): each group's controller state holds ``P * C_g``
lanes, point-major, and the frontend state one entry per point.  The
cycle loop itself runs on the host, one Python iteration per executed
cycle, and every iteration makes one launch of the fused controller step
per spec group on CUDA (each group has its own plan).

Two loops, bit-exact twins as in the reference:

* the per-cycle loop executes every cycle of every point, all at one
  clock, and never waits on the device;
* the fast-forward loop (the default) runs the points in lockstep, each
  at its own clock — what the reference's ``vmap`` of its
  ``lax.while_loop`` computes: every iteration executes one cycle of each
  point whose clock is below ``n_cycles`` (a finished point is frozen),
  then reads every point's busy verdict and event horizon (over the
  frontend and every group) back in ONE host sync (one packed ``(2, P)``
  tensor) and jumps each point's clock over its provably idle cycles in
  closed form (frontend accumulator refill + LCG jump).  The host uploads
  the next iteration's clocks, active flags and jumps in one non-blocking
  copy.

Trace replay (``Simulator(replay=...)``, ``FrontendConfig(pattern=
"trace")``) sends the stream's columns to the device once per run and
gathers each point's next request per cycle.  Windowed telemetry
(``run(telemetry=W)``, ``make_run(..., telemetry_window=W)``) folds its
gauges (served residency, the cumulative probe-latency histogram) beside
the stats each executed cycle, caps every point's jump at its next
window boundary and, when a point lands on one, copies that point's
counters into a preallocated ``(n_windows, P, C, ...)`` device buffer,
read back once after the loop: no host sync of its own.  With
``telemetry=0`` none of it runs.

Runs go through :class:`RunCache` (``RUN_CACHE``, as the reference's
``Simulator`` and ``repro.dse`` do): one :func:`make_run` per key, which
keeps what it sends to its device (DynParams, frontend tables, the
kernel's plans) for every later call.  ``format_stats``,
``channel_breakdown`` and ``Stats.summary`` give the reference's text.

Channel sharding (``Simulator(channel_shard=d)``, ``make_run(...,
shard=d)``; only on request, never because a process holds a group)
spreads every spec group's channels over the ``d`` ranks of the
``torch.distributed`` process group, one rank per device (the
reference's ``shard_map`` path): rank ``r`` owns a contiguous slice of
each group's channel axis, decodes the frontend replicated and inserts
into and steps only its own channels.  Per loop iteration the ranks
exchange two things: one fused int32 sum (the insert accepts, the
completion events and the issued count that the frontend and the busy
verdict read) and, with fast-forward, a min-reduce of the horizon: at
most two collectives, beside the iteration's one host sync.  Stats, the
dense trace and telemetry are gathered back onto the global channel axis
at the end, bit for bit those of the single-device run.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.core import controller as C
from repro_torch.core import device as D
from repro_torch.core import frontend as F
from repro_torch.core.compile import (CompiledSpec, MemorySystemSpec,
                                      SpecGroup, as_system, compile_spec)

I32 = torch.int32

#: :func:`make_run` builds in this process (the reference's name, where it
#: counts traces of a run closure): a sweep that hits :data:`RUN_CACHE`
#: builds nothing
TRACE_COUNT = 0


class ChannelStats(NamedTuple):
    """Per-channel counters; every leaf has a leading ``(C,)`` axis
    (``(P, C)`` for a batch of points)."""
    reads_done: torch.Tensor
    writes_done: torch.Tensor
    probe_lat_sum: torch.Tensor
    probe_cnt: torch.Tensor
    data_bus_busy: torch.Tensor     # cycles the channel's data bus was busy
    cmd_counts: torch.Tensor        # (C, n_cmds)
    deferred: torch.Tensor


class Stats(NamedTuple):
    """Aggregate run statistics plus the per-channel breakdown (the
    reference's fields).  The scalar fields sum over every channel of
    every spec group; ``per_channel`` splits them by system channel
    (group-major), its ``cmd_counts`` in the system's merged command
    namespace; ``per_group`` holds each group's :class:`ChannelStats` in
    its own namespace.  Counters are tensors on the run's device (or numpy
    arrays after ``convert.stats_to_numpy``); ``cycles``, ``scan_steps``
    and ``skipped_cycles`` are host ints.  A batch of ``P`` points
    (``Simulator.run_batch``) has a leading ``(P,)`` axis on every leaf,
    the three host counts as ``(P,)`` numpy arrays; :meth:`point` picks one
    point out as a scalar ``Stats``."""
    cycles: int
    reads_done: torch.Tensor
    writes_done: torch.Tensor
    probe_lat_sum: torch.Tensor
    probe_cnt: torch.Tensor
    data_bus_busy: torch.Tensor
    cmd_counts: torch.Tensor        # (n_cmds,)
    deferred: torch.Tensor
    per_channel: ChannelStats
    per_group: tuple
    #: executed cycles (the fast-forward loop's steps; ``cycles`` on the
    #: per-cycle loop)
    scan_steps: int = 0
    #: cycles the fast-forward horizon skipped (``cycles - scan_steps``)
    skipped_cycles: int = 0

    def point(self, i: int) -> "Stats":
        """Point ``i`` of batched stats, as the scalar ``Stats`` of one run
        (``to_dict`` and the derived metrics apply to it)."""
        pick = lambda ch: ChannelStats(*(a[i] for a in ch))
        host = lambda v: int(np.asarray(v)[i])
        return Stats(
            cycles=host(self.cycles),
            **{k: getattr(self, k)[i] for k in (
                "reads_done", "writes_done", "probe_lat_sum", "probe_cnt",
                "data_bus_busy", "cmd_counts", "deferred")},
            per_channel=pick(self.per_channel),
            per_group=tuple(pick(g) for g in self.per_group),
            scan_steps=host(self.scan_steps),
            skipped_cycles=host(self.skipped_cycles))

    def to_dict(self) -> dict:
        """Plain-Python counter dict of one scalar run (ints throughout;
        per-channel counters as lists) — the reference's
        ``Stats.to_dict``; index a batch with :meth:`point` first."""
        d = {k: int(getattr(self, k))
             for k in ("cycles", "reads_done", "writes_done",
                       "probe_lat_sum", "probe_cnt", "data_bus_busy",
                       "deferred", "scan_steps", "skipped_cycles")}
        d["cmd_counts"] = [int(c) for c in _np(self.cmd_counts)]
        ch = self.per_channel
        d["per_channel"] = {
            k: [int(v) for v in _np(getattr(ch, k))]
            for k in ("reads_done", "writes_done", "probe_cnt",
                      "data_bus_busy", "deferred")}
        return d

    def summary(self, spec=None) -> str:
        """Human-readable summary of one scalar run; with the run's spec
        or system, group-aware physical units (see :func:`format_stats`)."""
        return format_stats(self, spec)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GroupWindowSnap(NamedTuple):
    """One spec group's cumulative counters at each window boundary (the
    reference's ``GroupWindowSnap``): ``ch`` the :class:`ChannelStats` and
    ``tm`` the packed gauges ``(..., C, 1 + n_edges)`` — column 0 the
    cycle-sum of queue occupancy over ``[0, boundary)``, then the count of
    served probes with latency ``<= edge k``.  Numpy leaves with a leading
    ``(n_windows,)`` axis, then ``(P,)`` from ``make_run``."""
    ch: ChannelStats
    tm: np.ndarray


#: the scalar counters of a packed snapshot row, in column order; the
#: command counts and the gauges follow
_SNAP_FIELDS = ("reads_done", "writes_done", "probe_lat_sum", "probe_cnt",
                "data_bus_busy", "deferred")


class TraceArrays(NamedTuple):
    """Dense per-cycle trace of ``run(..., trace=True)``: ``[T, 2]``
    fields for a single channel ([cycles, bus slots]; slot 0 is the
    column C/A bus, slot 1 the row bus), ``[T, C, 2]`` for ``C`` system
    channels (a system's groups concatenated group-major; ``cmd`` ids are
    then group-local, which ``trace.capture`` resolves).  ``cmd`` is -1
    on idle slots."""
    cmd: torch.Tensor
    bank: torch.Tensor
    row: torch.Tensor
    arrive: torch.Tensor
    hit_ready: torch.Tensor  # bool


def _zero_channel_stats(cspec: CompiledSpec, lanes: tuple,
                        device) -> ChannelStats:
    z = lambda *sh: torch.zeros(lanes + sh, dtype=I32, device=device)
    return ChannelStats(z(), z(), z(), z(), z(), z(cspec.n_cmds), z())


def _accum_channel_stats(cspec: CompiledSpec, dp: D.DynParams,
                         ch: ChannelStats, ev: C.StepEvents) -> ChannelStats:
    """Fold one cycle's lane-stacked events into the running stats (an
    idle lane's events add nothing)."""
    rd = ev.served_read.to(I32)
    wr = ev.served_write.to(I32)
    # one-hot count of both bus slots (idle slots are -1: no match)
    issued = (dp.tables.cmd_ids == ev.cmd[..., None]).sum(-2, dtype=I32)
    return ChannelStats(
        reads_done=ch.reads_done + rd,
        writes_done=ch.writes_done + wr,
        probe_lat_sum=ch.probe_lat_sum + ev.probe_latency,
        probe_cnt=ch.probe_cnt + ev.served_probe.to(I32),
        data_bus_busy=ch.data_bus_busy + cspec.timings["nBL"] * (rd + wr),
        cmd_counts=ch.cmd_counts + issued,
        deferred=ch.deferred + ev.deferred,
    )


def _accum_gauges(edges: torch.Tensor, tm: torch.Tensor,
                  ev: C.StepEvents, clk) -> torch.Tensor:
    """Fold one cycle's telemetry gauges into ``tm`` ``(P, C, 1 + E)``:
    the served requests' queue residency ``clk - arrive`` (a request
    leaves its queue slot on the column bus, so its arrival is
    ``ev.arrive[..., 0]``) and, per latency edge, the served probes at or
    under it (an unserved probe's latency counts as ``1 << 30``)."""
    served = ev.served_read | ev.served_write
    res = (clk.view(-1, 1) - ev.arrive[..., 0]).masked_fill(~served, 0)
    lat = ev.probe_latency.masked_fill(~ev.served_probe, 1 << 30)
    return tm + torch.cat([res[..., None], (lat[..., None] <= edges).to(I32)],
                          -1)


def _snap_rows(cs: C.CtrlState, ch: ChannelStats, tm: torch.Tensor, clk: int,
               p: int | None = None) -> torch.Tensor:
    """One group's packed snapshot at clock ``clk``: ``(P, C, F)`` rows,
    or point ``p``'s ``(C, F)`` — the :data:`_SNAP_FIELDS`, the command
    counts, then the gauges with the residency of the requests still
    queued at ``clk`` added to column 0."""
    pick = (lambda a: a) if p is None else (lambda a: a[p])
    q = cs.queue
    resid = (clk - pick(q.arrive)).masked_fill(~pick(q.valid), 0).sum(
        -1, dtype=I32)
    g = pick(tm)
    return torch.cat([torch.stack([pick(getattr(ch, f))
                                   for f in _SNAP_FIELDS], -1),
                      pick(ch.cmd_counts), g[..., :1] + resid[..., None],
                      g[..., 1:]], -1)


def _unpack_snaps(cspec: CompiledSpec, buf: np.ndarray) -> GroupWindowSnap:
    """Packed snapshot rows ``(..., F)`` -> :class:`GroupWindowSnap`."""
    n = len(_SNAP_FIELDS)
    col = dict(zip(_SNAP_FIELDS, np.moveaxis(buf[..., :n], -1, 0)))
    return GroupWindowSnap(
        ch=ChannelStats(cmd_counts=buf[..., n:n + cspec.n_cmds], **col),
        tm=buf[..., n + cspec.n_cmds:])


def _point_snaps(snaps: tuple, i: int) -> tuple:
    """Point ``i`` of ``make_run``'s ``(n_windows, P, C, ...)`` snapshots."""
    return tuple(GroupWindowSnap(ChannelStats(*(a[:, i] for a in s.ch)),
                                 s.tm[:, i]) for s in snaps)


def check_replay(msys: MemorySystemSpec, replay: F.ReplayStream):
    """The reference's checks of a replay stream against a memory
    system: not empty, ``arrive`` non-decreasing, channels in range and
    ``sub`` as wide as the widest group's sub-levels."""
    if len(replay) == 0:
        raise ValueError("replay stream is empty — nothing to replay")
    if replay.arrive is not None \
            and np.any(np.diff(np.asarray(replay.arrive)) < 0):
        raise ValueError(
            "replay arrive column must be non-decreasing (injection is "
            "index-ordered) — sort the stream into arrival order as "
            "trace.to_replay does")
    top = int(np.max(replay.chan))
    if top >= msys.n_channels or int(np.min(replay.chan)) < 0:
        raise ValueError(
            f"replay stream targets channel {top} but the memory system "
            f"has {msys.n_channels} channel(s) — re-encode the stream "
            "through this system's mapper (ReplayStream.from_addresses) "
            "instead of reusing captured channels")
    max_sub = max(len(g.cspec.levels) - 1 for g in msys.groups)
    if replay.sub.shape[1] != max_sub:
        raise ValueError(
            f"replay sub columns are {replay.sub.shape[1]} wide but this "
            f"system needs {max_sub} sub-level indices — rebuild the "
            "stream against this system (ReplayStream.from_addresses / "
            "trace.to_replay)")


def _aggregate_stats(msys: MemorySystemSpec, chs: list, cycles: list,
                     steps: list) -> Stats:
    """Fold the groups' ``(P, C_g, ...)`` running stats into batched
    :class:`Stats`: per point, the sums over every channel.
    ``per_channel`` concatenates the groups' channels (group-major), each
    group's command counts lifted into the merged namespace."""
    lifted = []
    for gmap, ch in zip(msys.group_cmd_maps, chs):
        c = ch.cmd_counts
        lift = c.new_zeros(c.shape[:-1] + (msys.n_cmds,))
        lifted.append(lift.index_copy(
            -1, torch.as_tensor(gmap, device=c.device), c))
    cat = lambda f: torch.cat([getattr(ch, f) for ch in chs], 1)
    ch = ChannelStats(
        reads_done=cat("reads_done"), writes_done=cat("writes_done"),
        probe_lat_sum=cat("probe_lat_sum"), probe_cnt=cat("probe_cnt"),
        data_bus_busy=cat("data_bus_busy"),
        cmd_counts=torch.cat(lifted, 1), deferred=cat("deferred"))
    s = lambda a: a.sum(1, dtype=I32)
    cycles, steps = np.asarray(cycles), np.asarray(steps)
    return Stats(
        cycles=cycles, reads_done=s(ch.reads_done),
        writes_done=s(ch.writes_done), probe_lat_sum=s(ch.probe_lat_sum),
        probe_cnt=s(ch.probe_cnt), data_bus_busy=s(ch.data_bus_busy),
        cmd_counts=s(ch.cmd_counts), deferred=s(ch.deferred),
        per_channel=ch, per_group=tuple(chs), scan_steps=steps,
        skipped_cycles=cycles - steps)


class RunResult(NamedTuple):
    out: object             # batched Stats, or (Stats, TraceArrays)
    host_syncs: int         # device->host reads inside the cycle loop


class _Upload:
    """The host's per-iteration inputs of the fast-forward loop, packed in
    one byte buffer so that one non-blocking copy (from pinned memory on
    CUDA) sends them all: the rng maps ``ra``, ``rc`` (int64) of the idle
    jumps decided at the last sync, then each point's clock, the clock
    after it and the accumulator refill (int32), then the active flags.
    The device-side views are made once.  The host writes the buffer only
    after the last iteration's sync, so the previous copy has finished."""

    def __init__(self, points: int, device):
        P = points
        nbytes = 16 * P + 12 * P + P
        cuda = torch.device(device).type == "cuda"
        self.host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.host_views = self._views(self.host)
        self.ra, self.rc, self.clk, self.nxt, self.refill, self.active = \
            self._views(self.dev)
        self.np = [v.numpy() for v in self.host_views]

    @staticmethod
    def _views(buf):
        n = buf.shape[0] // 29
        i64 = buf[:16 * n].view(torch.int64)
        i32 = buf[16 * n:28 * n].view(torch.int32)
        return (i64[:n], i64[n:], i32[:n], i32[n:2 * n], i32[2 * n:],
                buf[28 * n:].view(torch.bool))

    def send(self, clks, jumps, active):
        """Write the clocks and the jumps ``(refill, ra, rc)`` per point,
        then copy them to the device."""
        ra, rc, clk, nxt, refill, act = self.np
        clk[:] = clks
        nxt[:] = [c + 1 for c in clks]
        act[:] = active
        refill[:], ra[:], rc[:] = zip(*jumps)
        self.dev.copy_(self.host, non_blocking=True)


def make_run(spec, ccfg: C.ControllerConfig, fcfg: F.FrontendConfig,
             n_cycles: int, trace: bool, fast_forward: bool = True,
             points: int | None = None,
             replay: F.ReplayStream | None = None,
             telemetry_window: int = 0, plans: dict | None = None,
             shard: int | None = None):
    """Build the run function ``(dps, fp, seed, device) -> RunResult`` of
    the design points of ``fp`` (its ``(P,)`` load knobs; batched
    :class:`Stats`; ``points``, when given, is the ``P`` every call must
    bring) over ``spec``, a :class:`CompiledSpec` or a
    :class:`MemorySystemSpec` (``dps``: one ``DynParams`` per group).
    The function keeps what it sends to a device once (the frontend and
    replay tables, the kernel's plans in ``plans``, its own store unless
    given one) for its later calls, so it must not outlive an edit of
    ``spec`` (:class:`RunCache` hands it a snapshot).

    Each iteration inserts the frontend's requests into the groups'
    queues, then steps every group's lanes (one fused launch per group on
    CUDA, each with the group's link latency), folds each group's events
    into its stats and the completions of all groups into the frontend.
    ``fast_forward`` (default on) executes one cycle per point and loop
    iteration, then jumps each point to ``min(max(horizon, clk + 1),
    n_cycles)``, where the horizon is the earliest cycle at which the
    point's frontend or any group's channels could act — or the next
    cycle when this one accepted or issued anything in any group.  With
    ``trace`` (one point only) the dense per-cycle buffers are
    idle-initialized and every executed cycle is written at its true
    index, so the trace is bit-identical to the per-cycle loop's.

    ``replay`` feeds ``pattern="trace"`` (checked by
    :func:`check_replay`).  ``telemetry_window = W > 0`` also returns, per
    spec group, a :class:`GroupWindowSnap` of every point's cumulative
    counters at each multiple of ``W`` (and at ``n_cycles`` when the last
    window is ragged or ``n_cycles < W``): a fast-forward jump never
    crosses a boundary, and a point that lands on one is snapshotted
    there.  The run's output is ``stats``, then the trace, then the
    snapshots, as a tuple when there is more than the stats.

    ``shard = d`` runs it channel-sharded (module notes) over the default
    ``torch.distributed`` process group, which must have ``d`` ranks (a
    run spans the whole group; ``d = 1`` runs the sharded loop, its
    collectives included, on one rank) and ``d`` must divide every
    group's channel count.  Every rank calls the run, each with its own
    ``device`` and ``dps`` made for its ``C_g / d`` channels; each gets
    the whole result.
    """
    global TRACE_COUNT
    msys = as_system(spec)
    groups = msys.groups
    if shard is not None:
        check_shard(msys, shard)
    if trace and points not in (None, 1):
        raise ValueError("trace=True records one point's run")
    if not 0 <= n_cycles <= 2**30:
        raise ValueError(f"n_cycles {n_cycles} outside [0, 2**30]: the "
                         "controller step takes clocks below 2**30")
    F.require_replay(fcfg, replay)
    if replay is not None:
        check_replay(msys, replay)
    TRACE_COUNT += 1
    W = telemetry_window
    n_full = n_cycles // W if W else 0
    # a ragged tail (or n_cycles < W) gets one more window
    n_windows = n_full + (1 if W and (n_cycles % W or not n_full) else 0)
    paced = F.paced_by_arrive(fcfg, replay)
    uploaded: dict = {}         # device -> (frontend, replay, edges) tables
    plans = {} if plans is None else plans   # controller.step_plan's store

    def tables(device, lo):
        key = (device.type, device.index)
        if key not in uploaded:
            st = F.system_front_tables(msys, fcfg, device)
            if shard is not None:
                st = _shard_front_tables(st, lo, local)
            uploaded[key] = (
                st,
                None if replay is None else F.replay_tables(replay, device),
                [torch.as_tensor(g.cspec.lat_bucket_edges, dtype=I32,
                                 device=device) for g in groups])
        return uploaded[key]

    # each group's channel count on a rank (all of them unsharded)
    local = [g.channels // (shard or 1) for g in groups]

    def run(dps, fp: F.FrontParams, seed: int, device):
        if isinstance(dps, D.DynParams):
            dps = (dps,)
        if len(dps) != msys.n_groups:
            raise ValueError(f"expected {msys.n_groups} DynParams (one per "
                             f"spec group), got {len(dps)}")
        device = torch.device(device)
        P = int(fp.interval_fp.shape[0])
        if points is not None and P != points:
            raise ValueError(f"this run takes {points} point(s), got {P}")
        if trace and P != 1:
            raise ValueError("trace=True records one point's run")
        rank = dist.get_rank() if shard is not None else 0
        lo = [rank * n for n in local]
        st, rt, edges = tables(device, lo)
        k_draws = st.k_draws
        a_cyc, c_cyc = F.lcg_affine(k_draws)
        cap = fcfg.max_backlog_fp

        def cycle(css, chs, tms, fs, clk, active, front_clk, front_active):
            """One executed cycle of every active point at its clock in
            every group; with fast-forward each group's step also returns
            its lanes' horizon at ``clk + 1`` on the new state (the
            frontend's commit and finish leave the controller state as it
            is), one kernel launch per group on CUDA.  The steps take the
            device clocks ``clk`` and flags ``active``; the frontend the
            same as ``front_clk`` and ``front_active``, a host int and None
            where
            every point runs at one clock (it then fills requests with
            ``masked_fill`` and skips the masks).  ``tms`` are the groups'
            telemetry gauges (None without telemetry).  Returns the busy
            verdict and the minimum horizon over the groups."""
            queues, draft = F.system_frontend_insert(
                msys, fcfg, fp, fs, tuple(cs.queue for cs in css),
                front_clk, st, front_active, rt)
            step = C.step_and_horizon if fast_forward else C.controller_step
            new_css, new_chs, evs, hc = [], [], [], None
            for gi, (grp, dp, cs, ch, queue) in enumerate(
                    zip(groups, dps, css, chs, queues)):
                out = step(grp.cspec, dp, ccfg, cs._replace(queue=queue),
                           clk, active, grp.link_latency, plans)
                ev = out[1]
                if fast_forward:
                    h = out[2].amin(-1)
                    hc = h if hc is None else torch.minimum(hc, h)
                new_css.append(out[0])
                new_chs.append(_accum_channel_stats(grp.cspec, dp, ch, ev))
                if tms is not None:
                    tms[gi] = _accum_gauges(edges[gi], tms[gi], ev, clk)
                evs.append(ev)
            absorb = F.absorb_locals(evs[0])
            for ev in evs[1:]:
                absorb = absorb + F.absorb_locals(ev)
            okp, ok = draft.okp, draft.ok
            issued = (evs[0].cmd >= 0).sum((-2, -1), dtype=I32)
            for ev in evs[1:]:
                issued = issued + (ev.cmd >= 0).sum((-2, -1), dtype=I32)
            if shard is not None:
                # the iteration's one sum over the ranks: [probe accepts,
                # stream accepts, probes done, served, probe completion,
                # issued] (at most one rank accepts a request, and one
                # probe completes per point: a sum is their max)
                v = torch.cat([torch.stack([okp, ok]), absorb,
                               issued[None]])
                dist.all_reduce(v)
                okp, ok, absorb, issued = v[0], v[1], v[2:5], v[5]
            fs = F.frontend_commit(fcfg, fp, fs, draft, okp, ok, paced)
            fs = F.frontend_finish(fs, fp, absorb[0], absorb[1], absorb[2])
            busy = okp + ok + issued
            return new_css, new_chs, fs, evs, busy > 0, hc

        css = [C.init_ctrl_state(g.cspec, ccfg.queue_depth, g.channels,
                                 device, ccfg.refresh_stagger, P)
               for g in groups]
        if shard is not None:
            # this rank's channels of the reset state (the refresh stagger
            # is a function of the global channel index)
            css = [C._tree(lambda a: a[:, l:l + n].contiguous(), cs)
                   for cs, l, n in zip(css, lo, local)]
        chs = [_zero_channel_stats(g.cspec, (P, n), device)
               for g, n in zip(groups, local)]
        fs = F.init_front(seed, device, P)
        clks, ys = [], []
        syncs = 0
        tms = bufs = None
        if W:
            tms = [torch.zeros((P, n, 1 + len(e)), dtype=I32,
                               device=device) for n, e in zip(local, edges)]
            bufs = [torch.zeros((n_windows, P, n,
                                 len(_SNAP_FIELDS) + g.cspec.n_cmds
                                 + 1 + len(e)), dtype=I32, device=device)
                    for g, n, e in zip(groups, local, edges)]

        def snapshot(k, clk, p=None):
            """Copy the groups' counters at clock ``clk`` (every point, or
            point ``p``) into window ``k`` of the snapshot buffers."""
            for buf, cs, ch, tm in zip(bufs, css, chs, tms):
                rows = _snap_rows(cs, ch, tm, clk, p)
                (buf[k] if p is None else buf[k, p]).copy_(rows)

        def record(evs, clk):
            if trace:
                clks.append(clk)
                ys.append(torch.stack([
                    torch.cat([getattr(ev, f)[0] for ev in evs])
                    for f in ("cmd", "bank", "row", "arrive")]
                    + [torch.cat([ev.hit_ready[0] for ev in evs]).to(I32)]))

        up = _Upload(P, device)
        if not fast_forward:
            # every point at one clock, counted on the device
            up.send([0] * P, [(0, 1, 0)] * P, [True] * P)
            for clk in range(n_cycles):
                css, chs, fs, evs, _, _ = cycle(
                    css, chs, tms, fs, up.clk, up.active, clk, None)
                record(evs, clk)
                up.clk.add_(1)
                if W and (clk + 1) % W == 0:
                    snapshot((clk + 1) // W - 1, clk + 1)
            steps = [n_cycles] * P
        else:
            jump_of = {0: (0, 1, 0)}     # d -> (refill, ra, rc), memoized

            def jump(d):
                hit = jump_of.get(d)
                if hit is None:
                    hit = jump_of[d] = (min(256 * d, cap) if fcfg.stream
                                        else 0,
                                        *F.lcg_power(d, a_cyc, c_cyc))
                return hit

            at = [0] * P                 # each point's clock
            steps = [0] * P
            dists = [0] * P              # the idle jump decided last sync
            while True:
                active = [t < n_cycles for t in at]
                if not any(active):
                    break
                up.send(at, [jump(d) for d in dists], active)
                if any(dists):
                    fs = F.idle_jump(fcfg, fs, up.refill, up.ra, up.rc,
                                     k_draws)
                # one point: the host's int clock serves the frontend
                one = P == 1
                css, chs, fs, evs, busy, hc = cycle(
                    css, chs, tms, fs, up.clk, up.active,
                    at[0] if one else up.clk, None if one else up.active)
                record(evs, at[0])
                h = torch.minimum(F.arrival_horizon(
                    fcfg, fp, fs, at[0] + 1 if one else up.nxt, rt), hc)
                if shard is not None:
                    # the earliest horizon over every rank's channels
                    dist.all_reduce(h, op=dist.ReduceOp.MIN)
                # the iteration's one host sync: busy verdicts + horizons
                both = torch.stack([busy.to(I32), h])
                is_busy, h = both.tolist()  # lint: ignore[ts102] the one sync
                syncs += 1
                for p in range(P):
                    dists[p] = 0
                    if not active[p]:
                        continue
                    steps[p] += 1
                    t = at[p] + 1
                    end = n_cycles
                    if W:                # never jump across a boundary
                        end = min(end, (at[p] // W + 1) * W)
                    target = min(t if is_busy[p] else max(h[p], t), end)
                    dists[p] = target - t
                    at[p] = target
                    if n_full and target % W == 0:
                        # the state after the executed cycle, at the
                        # boundary's clock (an idle jump moves only the
                        # frontend)
                        snapshot(target // W - 1, target, p)
        if W and n_windows > n_full:     # the ragged tail / n_cycles < W
            snapshot(n_windows - 1, n_cycles)
        ys = torch.stack(ys) if ys else None
        if shard is not None:
            # every rank's channels back onto the global channel axis
            chs = [ChannelStats(*(_gather_ranks(x, 1) for x in ch))
                   for ch in chs]
            if W:
                bufs = [_gather_ranks(b, 2) for b in bufs]
            if ys is not None:
                ys = _gather_trace(ys, local)
        stats = _aggregate_stats(msys, chs, [n_cycles] * P, steps)
        out = (stats,)
        if trace:
            out += (_dense_trace(clks, ys, n_cycles, msys.n_channels,
                                 device),)
        if W:
            out += (tuple(_unpack_snaps(g.cspec, b.cpu().numpy())
                          for g, b in zip(groups, bufs)),)
        return RunResult(out if len(out) > 1 else stats, syncs)

    return run


def check_shard(msys, shard: int):
    """Raise unless a channel-sharded run of ``msys`` over ``shard``
    ranks can start here: ``shard`` divides every group's channel count
    and is the default process group's size."""
    shard = int(shard)
    counts = [g.channels for g in msys.groups]
    if shard < 1 or any(c % shard for c in counts):
        raise ValueError(f"channel shard {shard} must be >= 1 and divide "
                         f"every group's channel count {counts}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != shard:
        raise ValueError(
            f"channel shard {shard} runs one rank per device over the "
            f"whole torch.distributed process group, which has {world} "
            "rank(s)" + ("" if dist.is_initialized() else
                         " (none is initialized)"))


def _shard_front_tables(st, lo, local):
    """The frontend tables of one rank: the same decode, with each group's
    channel ids cut to the rank's slice, so it inserts only there."""
    if st.single is not None:
        ft = st.single
        return st._replace(single=ft._replace(
            chan_ids=ft.chan_ids[lo[0]:lo[0] + local[0]]))
    return st._replace(groups=tuple(
        gf._replace(chan_ids=gf.chan_ids[l:l + n])
        for gf, l, n in zip(st.groups, lo, local)))


def _rank_parts(t: torch.Tensor) -> list:
    """Every rank's ``t``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def _gather_ranks(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    return torch.cat(_rank_parts(t), dim)


def _gather_trace(ys: torch.Tensor, local) -> torch.Tensor:
    """A rank's ``(T, 5, sum(local), 2)`` trace rows (its channels of each
    group, group-major) -> the global ``(T, 5, C, 2)`` rows: each group's
    channels from every rank in rank order, group-major."""
    parts = _rank_parts(ys)
    out, off = [], 0
    for n in local:
        out += [p[:, :, off:off + n] for p in parts]
        off += n
    return torch.cat(out, 2)


def _dense_trace(clks, ys, n_cycles, channels, device) -> TraceArrays:
    """Scatter the executed cycles' events (``ys``: ``(len(clks), 5, C,
    2)``, or None) into idle-initialized dense ``[T, 2]`` (single
    channel) or ``[T, C, 2]`` buffers."""
    buf = torch.full((n_cycles, 5, channels, 2), -1, dtype=I32,
                     device=device)
    buf[:, 4] = 0                               # hit_ready idles False
    if ys is not None:
        idx = torch.as_tensor(clks, dtype=torch.int64, device=device)
        buf[idx] = ys
    if channels == 1:
        buf = buf[:, :, 0]
    f = buf.unbind(1)
    return TraceArrays(cmd=f[0], bank=f[1], row=f[2], arrive=f[3],
                       hit_ready=f[4] != 0)


# --------------------------------------------------------------------------
# Run cache
# --------------------------------------------------------------------------
#
# `make_run` builds a fresh closure every call; `RunCache` keeps one per
# key: everything that changes the run (the system's fingerprint, the
# controller and frontend configs less the load knobs, the cycle count,
# trace, batch, replay stream, telemetry window, the device and
# fast-forward).  Load knobs and the seed are call arguments, so sweeping
# them never builds again.  An entry also holds what the run sends to its
# device once: the frontend tables, and — shared with the other entries
# of its system on that device — the groups' DynParams and the kernel's
# plans.


def _freeze(obj):
    """Recursively convert configs/dicts into hashable cache-key tuples.

    Callables (user predicates in ``extra_predicates``) freeze to their
    qualified name, bytecode and constants, closure cells and default
    arguments, so equal configs built by separate but identical factory
    calls share one entry.  A predicate that reads a module-level global
    which changes between runs is not re-keyed: bind state through
    closures or defaults."""
    if obj is None or isinstance(obj, (int, float, str, bool, bytes)):
        return obj
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _freeze(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(x) for x in obj)
    if callable(obj):
        cells = getattr(obj, "__closure__", None) or ()
        closure = tuple(_freeze(c.cell_contents) for c in cells)
        defaults = (_freeze(getattr(obj, "__defaults__", None)),
                    _freeze(getattr(obj, "__kwdefaults__", None)))
        code = getattr(obj, "__code__", None)
        code_key = ((code.co_code, _freeze(code.co_consts))
                    if code is not None else id(obj))
        return ("callable", getattr(obj, "__module__", ""),
                getattr(obj, "__qualname__", repr(obj)), code_key, closure,
                defaults)
    try:
        hash(obj)
        return obj
    except TypeError:
        return repr(obj)


def spec_fingerprint(cspec: CompiledSpec):
    """Hashable identity of a compiled spec as a run uses it: the preset
    names, the resolved timing table, ``rows`` and ``columns`` (which
    benchmarks edit in place) and, when above 1, the channel count — the
    reference's value, so stored trace artifacts of either package
    verify."""
    base = (cspec.standard, cspec.org_preset, cspec.timing_preset,
            _freeze(cspec.timings), cspec.rows, cspec.columns)
    return base if cspec.n_channels == 1 else base + (cspec.n_channels,)


def system_fingerprint(spec):
    """Hashable identity of a memory system: a bare spec and its 1-group
    zero-link system keep :func:`spec_fingerprint`; a composition is the
    tuple of (group fingerprint, channels, link latency)."""
    if isinstance(spec, CompiledSpec):
        return spec_fingerprint(spec)
    msys = as_system(spec)
    if msys.homogeneous:
        return spec_fingerprint(msys.groups[0].cspec)
    return tuple((spec_fingerprint(g.cspec), g.channels, g.link_latency)
                 for g in msys.groups)


def _device_key(device) -> tuple:
    """``(type, index)`` of a run's device, the index resolved for CUDA
    (``"cuda"`` and ``"cuda:0"`` are one device)."""
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return dev.type, index


#: mesh axis name of the channel-sharded engine path
CHANNEL_AXIS = "channels"


def auto_channel_shard(spec, n_devices: int | None = None) -> int | None:
    """The channel-mesh size ``d > 1`` a sharded run of ``spec`` would
    use: the device count (``n_devices``, default the ``torch.distributed``
    world size, 1 without a process group) when it divides EVERY spec
    group's channel count, else None.  The reference takes the largest
    such ``d`` up to its device count; a run here spans the whole process
    group, so it takes the group's size or nothing.  Only an explicit
    request (``Simulator(channel_shard=True)``) asks it: nothing shards
    because a process happens to hold a group."""
    msys = as_system(spec)
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    d = int(n_devices)
    if d > 1 and all(g.channels % d == 0 for g in msys.groups):
        return d
    return None


def _shard_desc(shard):
    """Hashable mesh identity of a channel-sharded run: the axis name,
    the mesh size, the process group's backend and this rank (a cache
    warmed under one topology never aliases another's runs); None for an
    unsharded run."""
    if shard is None:
        return None
    return (CHANNEL_AXIS, int(shard), dist.get_backend(),
            dist.get_rank())


def run_key(spec, ccfg: C.ControllerConfig, fcfg: F.FrontendConfig,
            n_cycles: int, trace: bool, batched: bool,
            replay: F.ReplayStream | None = None, telemetry: int = 0,
            device="cuda", fast_forward: bool = True,
            shard: int | None = None):
    """The reference's ``run_key`` with the run's device (type and index)
    in place of its device count, the channel mesh's descriptor
    (:func:`_shard_desc`; ``shard`` None for an unsharded run), and
    without ``donate``.  The load knobs (``interval``, ``read_ratio``) are
    left out: they reach the run as call arguments."""
    fkey = tuple(kv for kv in _freeze(fcfg)
                 if not (isinstance(kv, tuple)
                         and kv[0] in ("interval", "read_ratio")))
    key = (system_fingerprint(spec), _freeze(ccfg), fkey, int(n_cycles),
           bool(trace), bool(batched),
           None if replay is None else replay.fingerprint, int(telemetry),
           _device_key(device), bool(fast_forward))
    return key if shard is None else key + (_shard_desc(shard),)


class _SystemUploads:
    """What the runs of one system send to one device once: the groups'
    DynParams (made at first use) and the kernel's plans, shared by every
    :class:`RunCache` entry of that system and device (a 50-cycle warm-up
    and the 20,000-cycle run after it build one plan)."""

    def __init__(self, msys: MemorySystemSpec, device: torch.device,
                 shard: int | None = None):
        self.msys = msys
        self.device = device
        self.shard = shard
        self.plans: dict = {}
        self._dps = None

    @property
    def dps(self) -> tuple:
        """A channel-sharded run's are made for a rank's channels."""
        if self._dps is None:
            self._dps = tuple(D.dyn_params(g.cspec, self.device,
                                           g.channels // (self.shard or 1))
                              for g in self.msys.groups)
        return self._dps


class CachedRun:
    """One :class:`RunCache` entry: :func:`make_run`'s function over a
    snapshot of the spec, on one device, with its system's DynParams and
    kernel plans there.  ``entry(fp, seed) -> RunResult``.  The first
    call — the DynParams upload and the kernel's build at first use
    included, synchronized on CUDA — is timed into the owning cache's
    ``first_call_s``."""

    def __init__(self, msys: MemorySystemSpec, fn,
                 uploads: _SystemUploads, cache: "RunCache"):
        self.msys = msys
        self.fn = fn
        self.device = uploads.device
        self._uploads = uploads
        self._cache = cache
        self._timed = False

    @property
    def dps(self) -> tuple:
        """One ``DynParams`` per spec group, on the entry's device."""
        return self._uploads.dps

    def __call__(self, fp: F.FrontParams, seed: int) -> RunResult:
        if self._timed:
            return self.fn(self.dps, fp, seed, self.device)
        t0 = time.perf_counter()
        out = self.fn(self.dps, fp, seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._cache.first_call_s += time.perf_counter() - t0
        self._timed = True
        return out


class RunCache:
    """Memoizes :class:`CachedRun` entries (the reference's ``RunCache``).

    ``get`` returns the entry of a key, building it on a miss;
    ``hits``/``misses`` count lookups, the module-level
    :data:`TRACE_COUNT` counts builds, and ``stats()`` publishes the
    accounting for the run profiler and the sweep reports."""

    def __init__(self):
        self._runs: dict = {}
        #: (system fingerprint, device) -> _SystemUploads
        self._uploads: dict = {}
        self.hits = 0
        self.misses = 0
        #: cumulative wall seconds of every entry's first call (DynParams
        #: upload, kernel build at first use, one synchronized run)
        self.first_call_s = 0.0
        self._topologies: set = set()

    def __len__(self):
        return len(self._runs)

    def clear(self):
        self._runs.clear()
        self._uploads.clear()
        self._topologies.clear()
        self.hits = self.misses = 0
        self.first_call_s = 0.0

    def stats(self) -> dict:
        """``entries``, ``hits``/``misses`` (since construction or
        ``clear``), ``first_call_s``, ``devices`` (the devices of the
        cached runs) and ``shard_topologies`` (the distinct run
        topologies built: ``"lanes"`` for a run that steps its (point x
        channel) lanes on one device, ``"channels:<d>"`` for a run
        channel-sharded over ``d`` ranks)."""
        devices = {_device_key(e.device) for e in self._runs.values()}
        return {"entries": len(self._runs), "hits": self.hits,
                "misses": self.misses,
                "first_call_s": round(self.first_call_s, 3),
                "devices": len(devices),
                "shard_topologies": tuple(sorted(self._topologies))}

    def get(self, spec, ccfg: C.ControllerConfig, fcfg: F.FrontendConfig,
            n_cycles: int, trace: bool = False, batched: bool = False,
            replay: F.ReplayStream | None = None, telemetry: int = 0,
            shard: int | None = None, fast_forward: bool = True,
            device=None) -> CachedRun:
        """The entry of a run of ``spec`` (a :class:`CompiledSpec` or a
        :class:`MemorySystemSpec`) on ``device`` (``None``: the card).  A
        batched entry takes any number of points per call; an unbatched
        one (and every ``trace=True`` one) one point.  ``telemetry`` is
        the window in cycles (0 = off).  ``shard = d > 1`` is a run
        channel-sharded over the ``d`` ranks of the process group
        (:func:`make_run`; every rank gets its own entry); None or 1 is
        unsharded, as in the reference."""
        shard = int(shard) if shard and int(shard) > 1 else None
        if shard is not None:
            check_shard(as_system(spec), shard)
        device = _device.resolve(device)
        key = run_key(spec, ccfg, fcfg, n_cycles, trace, batched, replay,
                      telemetry, device, fast_forward, shard)
        entry = self._runs.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        self.misses += 1
        # close over a snapshot: a later in-place edit of the caller's
        # spec (rows, columns, a timing) must not reach this entry
        msys = MemorySystemSpec(tuple(
            SpecGroup(copy.deepcopy(g.cspec), g.channels, g.link_latency)
            for g in as_system(spec).groups))
        ukey = (key[0], _device_key(device), shard)
        uploads = self._uploads.get(ukey)
        if uploads is None:
            uploads = self._uploads[ukey] = _SystemUploads(msys, device,
                                                           shard)
        fn = make_run(msys, ccfg, fcfg, n_cycles, trace, fast_forward,
                      None if batched else 1, replay, telemetry,
                      uploads.plans, shard)
        entry = self._runs[key] = CachedRun(msys, fn, uploads, self)
        self._topologies.add("lanes" if shard is None
                             else f"{CHANNEL_AXIS}:{shard}")
        return entry


#: The process-wide cache of `Simulator` and `repro_torch.dse`.
RUN_CACHE = RunCache()


@dataclasses.dataclass
class Simulator:
    """User-facing memory-system handle: one (standard, org, timing)
    triple with a channel count and mapper order, OR a composition of spec
    groups via ``system=`` (a :class:`MemorySystemSpec` or a list of group
    descriptors, see ``compile_system``), run on ``device`` (``None`` =
    ``"cuda"``; raises without CUDA).

    >>> sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu")
    >>> stats = sim.run(10_000, interval=4.0, read_ratio=1.0)

    >>> pts, stats = sim.run_batch(10_000, [8, 2], [1.0, 0.5])
    >>> stats.point(0).to_dict()

    >>> cxl = Simulator(system=[
    ...     dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
    ...          timing_preset="DDR5_4800B", channels=2),
    ...     dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
    ...          timing_preset="DDR4_2400R", channels=2, link_latency=80),
    ... ], device="cpu")

    >>> stats, telem = sim.run(10_000, telemetry=1000)   # 10 windows
    >>> replayed = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R",
    ...                      frontend=FrontendConfig(pattern="trace"),
    ...                      replay=stream, device="cpu")

    ``host_syncs`` counts the device->host reads of every run's cycle
    loop (one per loop iteration with fast-forward, none without).

    ``channel_shard``: None (default), ``False``, ``0`` or ``1`` run
    unsharded, whatever process group the process holds; True shards a
    scalar run's channels over the whole ``torch.distributed`` process
    group (:func:`auto_channel_shard`; raises unless it has more than one
    rank and its size divides every group's channel count); ``d`` shards
    over ``d`` ranks (the group's size).  A sharded run is a collective
    program: every rank constructs the same ``Simulator`` on its own
    device and calls ``run`` alike.  (The reference's None shards over
    the visible devices of its one process; a run here spans processes,
    so it is asked for.)
    """
    standard: str | None = None
    org_preset: str | None = None
    timing_preset: str | None = None
    controller: C.ControllerConfig = dataclasses.field(
        default_factory=C.ControllerConfig)
    frontend: F.FrontendConfig = dataclasses.field(
        default_factory=F.FrontendConfig)
    timing_overrides: dict | None = None
    channels: int = 1
    #: convenience override for ``frontend.mapper`` (None keeps it)
    mapper: str | None = None
    #: the request stream of ``FrontendConfig(pattern="trace")``
    replay: F.ReplayStream | None = None
    #: a composition of spec groups: a :class:`MemorySystemSpec` or a list
    #: of group descriptors; exclusive with the (standard, org, timing)
    #: triple
    system: object = None
    channel_shard: object = None
    fast_forward: bool = True
    device: object = None

    def __post_init__(self):
        if self.system is not None:
            if self.standard is not None:
                raise ValueError("pass either a (standard, org_preset, "
                                 "timing_preset) triple or system=..., "
                                 "not both")
            if self.channels != 1 or self.timing_overrides is not None:
                raise ValueError(
                    "channels=/timing_overrides= apply to the (standard, "
                    "org, timing) path only — a system=... composition "
                    "carries its own per-group channel counts and timing "
                    "overrides (see compile_system)")
            self.msys = as_system(self.system)
            self.cspec = self.msys.groups[0].cspec \
                if self.msys.n_groups == 1 else None
        else:
            if self.standard is None:
                raise ValueError("Simulator needs a (standard, org_preset, "
                                 "timing_preset) triple or system=...")
            self.cspec = compile_spec(self.standard, self.org_preset,
                                      self.timing_preset,
                                      self.timing_overrides,
                                      channels=self.channels)
            self.msys = as_system(self.cspec)
        self.device = _device.resolve(self.device)
        if self.mapper is not None:
            self.frontend = dataclasses.replace(self.frontend,
                                                mapper=self.mapper)
        self._dps = None
        self.host_syncs = 0
        self._resolved_shard()          # an unusable explicit mesh raises

    def _resolved_shard(self) -> int | None:
        """The channel-mesh size scalar runs use, per ``channel_shard``."""
        cs = self.channel_shard
        if cs is True:
            d = auto_channel_shard(self.msys)
            if d is None:
                world = dist.get_world_size() if dist.is_initialized() \
                    else 1
                raise ValueError(
                    "channel_shard=True but no usable channel mesh: "
                    f"{world} rank(s) for per-group channel counts "
                    f"{[g.channels for g in self.msys.groups]}")
            return d
        if not cs or int(cs) <= 1:
            return None
        check_shard(self.msys, int(cs))
        return int(cs)

    @property
    def dps(self) -> tuple:
        """One ``DynParams`` per spec group on the simulator's device, made
        at first use (a run uses its :class:`RunCache` entry's)."""
        if self._dps is None:
            self._dps = tuple(D.dyn_params(g.cspec, self.device, g.channels)
                              for g in self.msys.groups)
        return self._dps

    @property
    def dp(self) -> D.DynParams:
        """Group 0's ``DynParams``."""
        return self.dps[0]

    def run(self, n_cycles: int, interval: float | None = None,
            read_ratio: float | None = None, trace: bool = False,
            seed: int = 0x1234, telemetry: int = 0,
            fast_forward: bool | None = None):
        """Run ``n_cycles``.  Returns ``stats``, plus the dense trace with
        ``trace=True``, plus a :class:`repro_torch.telemetry.Telemetry` of
        ``W``-cycle windows with ``telemetry=W > 0``: ``(stats, trace,
        telem)`` with both."""
        fcfg = self.frontend
        point = (fcfg.interval if interval is None else interval,
                 fcfg.read_ratio if read_ratio is None else read_ratio)
        out = self._run([point], n_cycles, trace, seed, fast_forward,
                        telemetry, shard=self._resolved_shard())
        if not (trace or telemetry):
            return out.point(0)
        res = (out[0].point(0),) + ((out[1],) if trace else ())
        if telemetry:
            from repro_torch import telemetry as T
            res += (T.build(self.msys, _point_snaps(out[-1], 0),
                            window=telemetry, n_cycles=n_cycles),)
        return res

    def run_batch(self, n_cycles: int, intervals, read_ratios,
                  seed: int = 0x1234):
        """Simulate the outer product of load points in one batched run:
        ``(pts, stats)``, ``pts`` the ``(interval, read_ratio)`` pairs in
        the reference's order and ``stats`` batched :class:`Stats` (use
        ``stats.point(i)`` for one point).  The points run in lockstep, one
        fused launch per spec group and loop iteration for all of them on
        CUDA."""
        pts = [(i, r) for i in intervals for r in read_ratios]
        return pts, self._run(pts, n_cycles, False, seed, self.fast_forward,
                              batched=True)

    def _run(self, pts, n_cycles, trace, seed, fast_forward, telemetry=0,
             batched=False, shard=None):
        """Run the points ``pts`` through the :data:`RUN_CACHE` entry of
        this system and run configuration."""
        ff = self.fast_forward if fast_forward is None else fast_forward
        entry = RUN_CACHE.get(self.msys, self.controller, self.frontend,
                              n_cycles, trace=trace, batched=batched,
                              replay=self.replay, telemetry=telemetry,
                              shard=shard, fast_forward=ff,
                              device=self.device)
        res = entry(F.stack_params(pts, self.frontend.probe_gap,
                                   self.device), seed)
        self.host_syncs += res.host_syncs
        return res.out


# --------------------------------------------------------------------------
# Derived metrics (one scalar run)
# --------------------------------------------------------------------------
#
# Every helper takes a CompiledSpec (homogeneous system) or a
# MemorySystemSpec.  For several groups the math is group-correct: each
# group's bytes and clock come from its own spec, and a spec/stats
# mismatch raises.


def _check_system_stats(msys: MemorySystemSpec, stats):
    got = len(getattr(stats, "per_group", ()) or ())
    if got != msys.n_groups:
        raise ValueError(
            f"stats carry {got} spec group(s) but the system has "
            f"{msys.n_groups} — these stats were produced by a different "
            "memory system (pass the matching spec/system)")


def throughput_gbps(spec, stats) -> float:
    """Achieved data throughput in GB/s (1e9 bytes per second): each
    group's bytes moved over the run's time on its own clock, summed."""
    msys = as_system(spec)
    _check_system_stats(msys, stats)
    total = 0.0
    for grp, ch in zip(msys.groups, stats.per_group):
        moved = float(int(_np(ch.reads_done).sum())
                      + int(_np(ch.writes_done).sum())) \
            * grp.cspec.access_bytes
        seconds = float(stats.cycles) * grp.cspec.tCK_ps * 1e-12
        total += moved / seconds / 1e9 if seconds else 0.0
    return total


def peak_gbps(spec) -> float:
    """Theoretical peak of the system's data buses in GB/s, summed over
    the groups (each on its own clock)."""
    msys = as_system(spec)
    return sum(g.channels * g.cspec.peak_bytes_per_cycle
               / (g.cspec.tCK_ps * 1e-12) / 1e9 for g in msys.groups)


def avg_probe_latency_ns(spec, stats) -> float:
    """Mean random-probe read latency in nanoseconds (arrival to data
    completion; CXL-attached groups include the round-trip link time) on
    the system's reference clock (group 0's), NaN when no probe
    finished."""
    if int(stats.probe_cnt) == 0:
        return float("nan")
    cycles = float(int(stats.probe_lat_sum)) / float(int(stats.probe_cnt))
    return cycles * as_system(spec).tCK_ps * 1e-3


def row_hit_rate(spec, stats) -> float:
    """``1 - ACT / (RD + WR)`` over every group's own command counts, NaN
    when no data command issued."""
    msys = as_system(spec)
    _check_system_stats(msys, stats)
    act = data = 0
    for grp, ch in zip(msys.groups, stats.per_group):
        counts = _np(ch.cmd_counts).sum(axis=0)
        names = grp.cspec.cmd_names
        act += sum(int(counts[i]) for i, n in enumerate(names)
                   if n.startswith("ACT"))
        data += sum(int(counts[i]) for i, n in enumerate(names)
                    if n in ("RD", "WR", "RDA", "WRA"))
    return 1.0 - act / data if data else float("nan")


def channel_breakdown(spec, stats) -> dict:
    """Per-system-channel summary of one scalar run: ``{channel: {group,
    standard, reads_done, writes_done, throughput_gbps, bus_util}}``, each
    channel on its own group's access size and clock."""
    msys = as_system(spec)
    _check_system_stats(msys, stats)
    out = {}
    c_sys = 0
    for g, (grp, ch) in enumerate(zip(msys.groups, stats.per_group)):
        seconds = float(stats.cycles) * grp.cspec.tCK_ps * 1e-12
        reads, writes = _np(ch.reads_done), _np(ch.writes_done)
        busy = _np(ch.data_bus_busy)
        for c in range(grp.channels):
            moved = (int(reads[c]) + int(writes[c])) * grp.cspec.access_bytes
            out[c_sys] = {
                "group": g,
                "standard": grp.cspec.standard or grp.cspec.name,
                "reads_done": int(reads[c]),
                "writes_done": int(writes[c]),
                "throughput_gbps": moved / seconds / 1e9 if seconds else 0.0,
                "bus_util": (float(busy[c]) / float(stats.cycles)
                             if int(stats.cycles) else 0.0),
            }
            c_sys += 1
    return out


def format_stats(stats, spec=None) -> str:
    """Human-readable summary of one scalar run's ``stats`` (the
    reference's text): raw counters without a spec; with the run's spec or
    system also GB/s against peak, probe latency in ns, the row-hit rate
    and a per-channel table labelled by each channel's standard."""
    cyc = int(stats.cycles)
    lines = [f"cycles            {cyc:>14,}",
             f"reads done        {int(stats.reads_done):>14,}",
             f"writes done       {int(stats.writes_done):>14,}",
             f"deferred          {int(stats.deferred):>14,}"]
    skipped = int(stats.skipped_cycles)
    if cyc:
        lines.append(f"idle fast-forward {skipped / cyc:>14.1%}  "
                     f"({int(stats.scan_steps):,} scan steps)")
    if spec is None:
        if cyc:
            lines.append(f"bus busy          "
                         f"{int(stats.data_bus_busy) / cyc:>14.1%}")
        return "\n".join(lines)
    msys = as_system(spec)
    _check_system_stats(msys, stats)
    ach = throughput_gbps(msys, stats)
    lines += [f"throughput (GB/s) {ach:>14.2f}  "
              f"(peak {peak_gbps(msys):.2f})",
              f"probe latency(ns) {avg_probe_latency_ns(msys, stats):>14.1f}"]
    hit = row_hit_rate(msys, stats)
    if hit == hit:                          # NaN-safe
        lines.append(f"row-hit rate      {hit:>14.1%}")
    bd = channel_breakdown(msys, stats)
    if len(bd) > 1 or msys.n_groups > 1:
        lines.append("channel  standard     reads      writes   "
                     "GB/s   bus-util")
        for c, d in bd.items():
            lines.append(
                f"{c:>7}  {d['standard']:<9}{d['reads_done']:>10,}"
                f"{d['writes_done']:>12,}{d['throughput_gbps']:>7.2f}"
                f"{d['bus_util']:>10.1%}")
    return "\n".join(lines)
