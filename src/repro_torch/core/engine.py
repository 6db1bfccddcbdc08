"""Cycle-level memory-system engine for one homogeneous standard.

The counterpart of ``repro.core.engine``: it composes (frontend ->
address mapper -> controller -> device) into one cycle function and runs
it for ``n_cycles``.  All simulation state lives on the run's device with
a leading channel axis; the cycle loop itself runs on the host, one Python
iteration per executed cycle.

Two loops, bit-exact twins as in the reference:

* the per-cycle loop executes every cycle and never waits on the device;
* the fast-forward loop (the default) executes one cycle, then reads the
  cycle's busy verdict and the event horizon back in ONE host sync (one
  packed two-element tensor) and jumps the clock over the provably idle
  cycles in closed form (frontend accumulator refill + LCG jump).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
entry: multi-channel systems, heterogeneous ``system=`` compositions,
trace replay, windowed telemetry, batched ``run_batch`` and channel
sharding.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import controller as C
from repro_torch.core import device as D
from repro_torch.core import frontend as F
from repro_torch.core.compile import CompiledSpec, compile_spec

I32 = torch.int32


class ChannelStats(NamedTuple):
    """Per-channel counters; every leaf has a leading ``(C,)`` axis."""
    reads_done: torch.Tensor
    writes_done: torch.Tensor
    probe_lat_sum: torch.Tensor
    probe_cnt: torch.Tensor
    data_bus_busy: torch.Tensor     # cycles the channel's data bus was busy
    cmd_counts: torch.Tensor        # (C, n_cmds)
    deferred: torch.Tensor


class Stats(NamedTuple):
    """Aggregate run statistics plus the per-channel breakdown (the
    reference's fields; ``per_group`` is the 1-tuple of the one spec
    group).  Counters are tensors on the run's device (or numpy arrays
    after ``convert.stats_to_numpy``); ``cycles``, ``scan_steps`` and
    ``skipped_cycles`` are host ints."""
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

    def to_dict(self) -> dict:
        """Plain-Python counter dict (ints throughout; per-channel
        counters as lists) — the reference's ``Stats.to_dict``."""
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


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TraceArrays(NamedTuple):
    """Dense per-cycle trace of ``run(..., trace=True)``: ``[T, 2]``
    fields for a single channel ([cycles, bus slots]; slot 0 is the
    column C/A bus, slot 1 the row bus).  ``cmd`` is -1 on idle slots."""
    cmd: torch.Tensor
    bank: torch.Tensor
    row: torch.Tensor
    arrive: torch.Tensor
    hit_ready: torch.Tensor  # bool


def _zero_channel_stats(cspec: CompiledSpec, channels: int,
                        device) -> ChannelStats:
    z = lambda *sh: torch.zeros((channels,) + sh, dtype=I32, device=device)
    return ChannelStats(z(), z(), z(), z(), z(), z(cspec.n_cmds), z())


def _accum_channel_stats(cspec: CompiledSpec, dp: D.DynParams,
                         ch: ChannelStats, ev: C.StepEvents) -> ChannelStats:
    """Fold one cycle's channel-stacked events into the running stats."""
    rd = ev.served_read.to(I32)
    wr = ev.served_write.to(I32)
    # one-hot count of both bus slots (idle slots are -1: no match)
    issued = (dp.tables.cmd_ids == ev.cmd[:, :, None]).sum(1, dtype=I32)
    return ChannelStats(
        reads_done=ch.reads_done + rd,
        writes_done=ch.writes_done + wr,
        probe_lat_sum=ch.probe_lat_sum + ev.probe_latency,
        probe_cnt=ch.probe_cnt + ev.served_probe.to(I32),
        data_bus_busy=ch.data_bus_busy + cspec.timings["nBL"] * (rd + wr),
        cmd_counts=ch.cmd_counts + issued,
        deferred=ch.deferred + ev.deferred,
    )


def _aggregate_stats(ch: ChannelStats, clk: int,
                     scan_steps: int | None = None) -> Stats:
    """Fold the per-channel running stats into :class:`Stats`."""
    s = lambda a: a.sum(0, dtype=I32)
    steps = clk if scan_steps is None else scan_steps
    return Stats(
        cycles=clk, reads_done=s(ch.reads_done),
        writes_done=s(ch.writes_done), probe_lat_sum=s(ch.probe_lat_sum),
        probe_cnt=s(ch.probe_cnt), data_bus_busy=s(ch.data_bus_busy),
        cmd_counts=s(ch.cmd_counts), deferred=s(ch.deferred),
        per_channel=ch, per_group=(ch,), scan_steps=steps,
        skipped_cycles=clk - steps)


class RunResult(NamedTuple):
    out: object             # Stats, or (Stats, TraceArrays)
    host_syncs: int         # device->host reads inside the cycle loop


def make_run(cspec: CompiledSpec, ccfg: C.ControllerConfig,
             fcfg: F.FrontendConfig, n_cycles: int, trace: bool,
             fast_forward: bool = True):
    """Build the run function ``(dp, fp, seed, device) -> RunResult``.

    ``fast_forward`` (default on) executes one cycle per loop iteration,
    then jumps to ``min(max(horizon, clk + 1), n_cycles)``, where the
    horizon is the earliest cycle at which the frontend or the channel
    could act (``F.arrival_horizon``, the step's channel horizon) — or the
    next cycle when this one accepted or issued anything.  With ``trace`` the
    dense per-cycle buffers are idle-initialized and every executed cycle
    is written at its true index, so the trace is bit-identical to the
    per-cycle loop's."""
    channels = cspec.n_channels

    def run(dp: D.DynParams, fp: F.FrontParams, seed: int, device):
        ft = F.front_tables(cspec, fcfg, channels, device)
        k_draws = int(ft.draw_c.numel())
        a_cyc, c_cyc = F.lcg_affine(k_draws)

        def cycle(cs, ch, fs, clk):
            """One executed cycle; with fast-forward the controller step
            also returns the channels' horizon at ``clk + 1`` on its new
            state (the frontend's commit and finish leave ``cs`` as it is),
            one kernel launch on CUDA."""
            queue, draft = F.frontend_insert(cspec, fcfg, fp, fs, cs.queue,
                                             clk, ft)
            cs = cs._replace(queue=queue)
            hc = None
            if fast_forward:
                cs, ev, hc = C.step_and_horizon(cspec, dp, ccfg, cs, clk)
            else:
                cs, ev = C.controller_step(cspec, dp, ccfg, cs, clk)
            ch = _accum_channel_stats(cspec, dp, ch, ev)
            absorb = F.absorb_locals(ev)
            fs = F.frontend_commit(fcfg, fp, fs, draft, draft.okp, draft.ok)
            fs = F.frontend_finish(fs, fp, absorb[0], absorb[1], absorb[2])
            busy = (draft.okp + draft.ok + (ev.cmd >= 0).sum(dtype=I32)) > 0
            return cs, ch, fs, ev, busy, hc

        def horizon(fs, hc, clk):
            """min over the frontend's and the channels' next events."""
            h = F.arrival_horizon(fcfg, fp, fs, clk)
            return torch.minimum(h, hc.amin())

        def idle_jump(fs, d):
            return F.idle_advance(fcfg, fs, d, a_cyc, c_cyc, k_draws)

        cs = C.init_ctrl_state(cspec, ccfg.queue_depth, channels, device)
        ch = _zero_channel_stats(cspec, channels, device)
        fs = F.init_front(seed, device)
        clks, ys = [], []
        syncs = 0
        clk = steps = 0
        while clk < n_cycles:
            cs, ch, fs, ev, busy, hc = cycle(cs, ch, fs, clk)
            if trace:
                clks.append(clk)
                ys.append(torch.stack([ev.cmd, ev.bank, ev.row, ev.arrive,
                                       ev.hit_ready.to(I32)]))
            steps += 1
            clk += 1
            if not fast_forward:
                continue
            h = horizon(fs, hc, clk)
            # the step's one host sync: busy verdict + horizon together
            is_busy, h = torch.stack([busy.to(I32), h]).tolist()
            syncs += 1
            target = min(clk if is_busy else max(h, clk), n_cycles)
            if target > clk:
                fs = idle_jump(fs, target - clk)
                clk = target

        stats = _aggregate_stats(ch, n_cycles, steps)
        if not trace:
            return RunResult(stats, syncs)
        return RunResult((stats, _dense_trace(clks, ys, n_cycles, channels,
                                              device)), syncs)

    return run


def _dense_trace(clks, ys, n_cycles, channels, device) -> TraceArrays:
    """Scatter the executed cycles' events into idle-initialized dense
    ``[T, 2]`` (single channel) or ``[T, C, 2]`` buffers."""
    buf = torch.full((n_cycles, 5, channels, 2), -1, dtype=I32,
                     device=device)
    buf[:, 4] = 0                               # hit_ready idles False
    if ys:
        idx = torch.as_tensor(clks, dtype=torch.int64, device=device)
        buf[idx] = torch.stack(ys)
    if channels == 1:
        buf = buf[:, :, 0]
    f = buf.unbind(1)
    return TraceArrays(cmd=f[0], bank=f[1], row=f[2], arrive=f[3],
                       hit_ready=f[4] != 0)


@dataclasses.dataclass
class Simulator:
    """User-facing memory-system handle: one (standard, org, timing)
    triple, run on ``device`` (``None`` = ``"cuda"``; raises without
    CUDA).

    >>> sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu")
    >>> stats = sim.run(10_000, interval=4.0, read_ratio=1.0)

    ``host_syncs`` counts the device->host reads of every run's cycle
    loop (one per executed step with fast-forward, none without).
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
    replay: object = None
    system: object = None
    channel_shard: object = None
    fast_forward: bool = True
    device: object = None

    def __post_init__(self):
        if self.system is not None:
            raise NotImplementedError(
                "Simulator(system=...): heterogeneous compositions are not "
                "ported to repro_torch yet — see ROADMAP.md queue 1 item 9")
        if self.replay is not None:
            raise NotImplementedError(
                "Simulator(replay=...): trace replay is not ported to "
                "repro_torch yet — see ROADMAP.md queue 1 item 10")
        if self.channel_shard not in (None, False):
            raise NotImplementedError(
                "Simulator(channel_shard=...): multi-GPU channel sharding "
                "is not ported yet — see ROADMAP.md queue 1 item 12")
        if self.channels != 1:
            raise NotImplementedError(
                f"Simulator(channels={self.channels}): multi-channel "
                "systems are not ported to repro_torch yet — see "
                "ROADMAP.md queue 1 item 6")
        if self.standard is None:
            raise ValueError("Simulator needs a (standard, org_preset, "
                             "timing_preset) triple")
        self.device = _device.resolve(self.device)
        self.cspec = compile_spec(self.standard, self.org_preset,
                                  self.timing_preset, self.timing_overrides,
                                  channels=self.channels)
        if self.mapper is not None:
            self.frontend = dataclasses.replace(self.frontend,
                                                mapper=self.mapper)
        self.dp = D.dyn_params(self.cspec, self.device, self.channels)
        self.host_syncs = 0

    def run(self, n_cycles: int, interval: float | None = None,
            read_ratio: float | None = None, trace: bool = False,
            seed: int = 0x1234, telemetry: int = 0,
            fast_forward: bool | None = None):
        """Run ``n_cycles``.  Returns ``stats``, or ``(stats, trace)``
        with ``trace=True``."""
        if telemetry:
            raise NotImplementedError(
                "run(telemetry=W): windowed telemetry is not ported to "
                "repro_torch yet — see ROADMAP.md queue 1 item 8")
        fcfg = self.frontend
        if interval is not None or read_ratio is not None:
            fcfg = dataclasses.replace(
                fcfg,
                interval=interval if interval is not None else fcfg.interval,
                read_ratio=(read_ratio if read_ratio is not None
                            else fcfg.read_ratio))
        ff = self.fast_forward if fast_forward is None else fast_forward
        res = make_run(self.cspec, self.controller, fcfg, n_cycles, trace,
                       ff)(self.dp, fcfg.params(), seed, self.device)
        self.host_syncs += res.host_syncs
        return res.out

    def run_batch(self, n_cycles: int, intervals, read_ratios,
                  seed: int = 0x1234):
        raise NotImplementedError(
            "run_batch: batched design points are not ported to "
            "repro_torch yet — see ROADMAP.md queue 1 item 7")


# --------------------------------------------------------------------------
# Derived metrics (one scalar run of one homogeneous spec)
# --------------------------------------------------------------------------


def throughput_gbps(cspec: CompiledSpec, stats) -> float:
    """Achieved data throughput in GB/s (1e9 bytes per second)."""
    moved = float(int(stats.reads_done) + int(stats.writes_done)) \
        * cspec.access_bytes
    seconds = float(stats.cycles) * cspec.tCK_ps * 1e-12
    return moved / seconds / 1e9 if seconds else 0.0


def peak_gbps(cspec: CompiledSpec) -> float:
    """Theoretical peak of the system's data buses in GB/s."""
    return cspec.n_channels * cspec.peak_bytes_per_cycle \
        / (cspec.tCK_ps * 1e-12) / 1e9


def avg_probe_latency_ns(cspec: CompiledSpec, stats) -> float:
    """Mean random-probe read latency in nanoseconds, NaN when no probe
    finished."""
    if int(stats.probe_cnt) == 0:
        return float("nan")
    cycles = float(int(stats.probe_lat_sum)) / float(int(stats.probe_cnt))
    return cycles * cspec.tCK_ps * 1e-3


def row_hit_rate(cspec: CompiledSpec, stats) -> float:
    """``1 - ACT / (RD + WR)`` over the run's command counts, NaN when no
    data command issued."""
    counts = _np(stats.cmd_counts)
    names = cspec.cmd_names
    act = sum(int(counts[i]) for i, n in enumerate(names)
              if n.startswith("ACT"))
    data = sum(int(counts[i]) for i, n in enumerate(names)
               if n in ("RD", "WR", "RDA", "WRA"))
    return 1.0 - act / data if data else float("nan")
