"""Property-based scheduler invariants over adversarial request streams.

The port's copy of ``repro.verify.properties``: the streams and checks
are the reference's numpy code; the runs are the port's ``Simulator``
(the fused controller-step kernel on the card).

Where the exploration layer (:mod:`repro_torch.verify.explore`) exhausts tiny
state spaces, this layer stresses FULL device organizations — any of
the registered standards, multi-channel fan-outs, and heterogeneous
CXL-style compositions — with adversarial replay streams and checks
system-level invariants on the captured command trace:

* ``audit_clean``      — the trace satisfies every timing constraint and
  scheduler invariant (``repro_torch.trace.audit``, per group for hetero);
* ``refresh_deadline`` — consecutive all-bank refreshes per (channel,
  refresh unit) are never further apart than a bound derived from nREFI,
  the controller's urgency margin and worst-case command latencies, and
  at least one refresh lands when the horizon admits one (the
  refresh-starving stream exists to tempt the scheduler into skipping
  them forever);
* ``faw_window``       — an independent sliding-window re-check of every
  ``window > 1`` same-command constraint (tFAW-style), computed directly
  from sorted issue clocks rather than through the auditor's ring
  machinery;
* ``starvation_bound`` — every served request waits at most
  ``(queue_depth + 2) * 2 * (max constraint latency + 16)`` cycles, and
  forward progress happened at all.  FR-FCFS has no *constant* fairness
  bound under unbounded same-row pressure, so the adversarial generators
  bound their row-hit run lengths; the bound above is generous but
  finite — a genuinely starving scheduler runs away from it linearly.

Streams are generated by seeded numpy so the same adversarial traffic
can be driven both from hypothesis (property tests) and from fixed-seed
fallbacks in environments without it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import frontend as F
from repro_torch.core.compile import MemorySystemSpec
from repro_torch.core.engine import Simulator
from repro_torch.core.spec import FX_FINAL_RD, FX_FINAL_WR
from repro_torch.trace.audit import audit as _audit
from repro_torch.trace.capture import capture

from .explore import bank_sub, node_of


# ---------------------------------------------------------------------------
# Adversarial stream generators
# ---------------------------------------------------------------------------

def _spec_of_chan(system, chan: int):
    if isinstance(system, MemorySystemSpec):
        return system.groups[int(system.chan_group[chan])].cspec
    return system


def _n_channels(system) -> int:
    if isinstance(system, MemorySystemSpec):
        return int(system.n_channels)
    return int(system.level_counts[0])


def _sub_width(system) -> int:
    if isinstance(system, MemorySystemSpec):
        return max(len(g.cspec.levels) - 1 for g in system.groups)
    return len(system.levels) - 1


def _mk_stream(system, recs) -> F.ReplayStream:
    """(chan, bank, row, is_write, arrive) records -> ReplayStream."""
    width = _sub_width(system)
    chan = np.asarray([r[0] for r in recs], np.int32)
    sub = np.zeros((len(recs), width), np.int32)
    for k, (c, b, _, _, _) in enumerate(recs):
        s = bank_sub(_spec_of_chan(system, c), b)
        sub[k, :len(s)] = s
    return F.ReplayStream(
        chan=chan, sub=sub,
        row=np.asarray([r[2] for r in recs], np.int32),
        col=np.zeros(len(recs), np.int32),
        is_write=np.asarray([int(r[3]) for r in recs], np.int32),
        arrive=np.asarray([r[4] for r in recs], np.int32))


def bursty_stream(system, *, n=160, seed=0, burst=8, gap=48,
                  write_ratio=0.3) -> F.ReplayStream:
    """Dense bursts separated by idle gaps: stresses queue-full
    backpressure and post-idle refresh catch-up."""
    rng = np.random.default_rng(seed)
    recs, t = [], 0
    while len(recs) < n:
        for _ in range(burst):
            if len(recs) >= n:
                break
            c = int(rng.integers(_n_channels(system)))
            cs = _spec_of_chan(system, c)
            recs.append((c, int(rng.integers(cs.n_banks)),
                         int(rng.integers(min(int(cs.rows), 64))),
                         rng.random() < write_ratio, t))
        t += gap
    return _mk_stream(system, recs)


def row_conflict_stream(system, *, n=160, seed=0, run=6,
                        interval=2) -> F.ReplayStream:
    """Row-conflict-heavy: bounded runs to the same (bank, row), then a
    forced conflict on the same bank — maximal precharge/activate churn
    with run lengths capped so FR-FCFS fairness stays bounded."""
    rng = np.random.default_rng(seed)
    recs, t = [], 0
    while len(recs) < n:
        c = int(rng.integers(_n_channels(system)))
        cs = _spec_of_chan(system, c)
        bank = int(rng.integers(cs.n_banks))
        row = int(rng.integers(min(int(cs.rows), 64)))
        for k in range(int(rng.integers(2, run + 1))):
            if len(recs) >= n:
                break
            r = row if k % 2 == 0 else (row + 1) % min(int(cs.rows), 64)
            recs.append((c, bank, r, bool(rng.random() < 0.2), t))
            t += interval
    return _mk_stream(system, recs)


def refresh_starving_stream(system, *, n=256, seed=0,
                            interval=1) -> F.ReplayStream:
    """A continuous stream of row hits to one hot row per bank — the
    adversary that tempts an opportunistic refresh policy into deferring
    forever.  The urgency margin must still force refreshes through."""
    rng = np.random.default_rng(seed)
    hot = {}
    recs, t = [], 0
    for _ in range(n):
        c = int(rng.integers(_n_channels(system)))
        cs = _spec_of_chan(system, c)
        bank = int(rng.integers(cs.n_banks))
        row = hot.setdefault((c, bank),
                             int(rng.integers(min(int(cs.rows), 64))))
        recs.append((c, bank, row, False, t))
        t += interval
    return _mk_stream(system, recs)


STREAMS = {"bursty": bursty_stream,
           "row_conflict": row_conflict_stream,
           "refresh_starving": refresh_starving_stream}


# ---------------------------------------------------------------------------
# Invariant checks on a captured trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PropertyReport:
    name: str
    checks: dict                   # check name -> violation count
    details: list                  # human-readable violation strings
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(v == 0 for v in self.checks.values())

    def __str__(self):
        body = ", ".join(f"{k}={v}" for k, v in self.checks.items())
        return f"properties[{self.name}]: {body}" + \
            ("" if self.ok else " FAIL")


def _events_of_group(tr, gi: int):
    """Mask selecting one group's events (everything for homogeneous)."""
    if tr.group is None:
        return np.ones(len(tr.clk), bool)
    return np.asarray(tr.group) == gi


def _group_iter(system, tr):
    """Yield (group_index, cspec, mask, local_cmd_of_merged) tuples."""
    if isinstance(system, MemorySystemSpec) and not system.homogeneous:
        for gi, g in enumerate(system.groups):
            mask = _events_of_group(tr, gi)
            # merged trace ids -> the group's local ids (-1: not ours)
            local = np.full(len(tr.cmd_names), -1, np.int64)
            for loc, glob in enumerate(system.group_cmd_maps[gi]):
                local[int(glob)] = loc
            yield gi, g.cspec, mask, local
    else:
        cspec = system.groups[0].cspec \
            if isinstance(system, MemorySystemSpec) else system
        yield 0, cspec, np.ones(len(tr.clk), bool), \
            np.arange(len(tr.cmd_names))


def refresh_deadline_bound(cspec, ccfg: C.ControllerConfig) -> int:
    """Worst-case gap between all-bank refreshes on one refresh unit:
    the deadline (nREFI), the controller's opportunistic-deferral margin,
    and a serialization allowance for every other unit's refresh plus
    the longest constraint chain into/out of REFab."""
    maxlat = max(int(np.max(cspec.ct_lat)), 1)
    return (int(cspec.timings["nREFI"]) + int(ccfg.refresh_urgent_margin)
            + int(cspec.n_refresh_units) * 2 * (maxlat + 8) + 16)


def check_refresh_deadline(system, tr, ccfg) -> tuple[int, list, dict]:
    """No (channel, refresh-unit) ever exceeds the refresh bound, and the
    check is non-vacuous: each unit refreshed at least once when the
    horizon admits it."""
    bad, info = [], {}
    chan = np.zeros(len(tr.clk), np.int64) if tr.chan is None \
        else np.asarray(tr.chan, np.int64)
    for gi, cspec, mask, local in _group_iter(system, tr):
        if "REFab" not in tr.cmd_names:
            continue
        bound = refresh_deadline_bound(cspec, ccfg)
        info[f"g{gi}_bound"] = bound
        ref_id = tr.cmd_names.index("REFab")
        banks_per_ru = int(cspec.n_banks) // int(cspec.n_refresh_units)
        sel = mask & (np.asarray(tr.cmd) == ref_id)
        chans = sorted(set(chan[mask].tolist()))
        for c in chans:
            for ru in range(int(cspec.n_refresh_units)):
                here = sel & (chan == c) & \
                    (np.asarray(tr.bank) // banks_per_ru == ru)
                clks = np.sort(np.asarray(tr.clk)[here])
                edges = np.concatenate([[0], clks, [int(tr.n_cycles)]])
                gaps = np.diff(edges)
                if len(clks) == 0 and int(tr.n_cycles) > bound:
                    bad.append(f"g{gi} ch{c} ru{ru}: no REFab in "
                               f"{tr.n_cycles} cycles (bound {bound})")
                elif int(gaps.max()) > bound:
                    bad.append(f"g{gi} ch{c} ru{ru}: refresh gap "
                               f"{int(gaps.max())} > bound {bound}")
    return len(bad), bad, info


def check_faw_windows(system, tr) -> tuple[int, list]:
    """Independent sliding-window re-check of every window > 1
    same-command constraint row, directly on sorted issue clocks."""
    bad = []
    chan = np.zeros(len(tr.clk), np.int64) if tr.chan is None \
        else np.asarray(tr.chan, np.int64)
    cmd = np.asarray(tr.cmd)
    for gi, cspec, mask, local in _group_iter(system, tr):
        glob_of_local = {int(l): g for g, l in
                         ((g, local[g]) for g in range(len(local)))
                         if l >= 0}
        for i in range(len(cspec.ct_prev)):
            win = int(cspec.ct_win[i])
            p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
            if win <= 1 or p != f or p not in glob_of_local:
                continue
            lat, level = int(cspec.ct_lat[i]), int(cspec.ct_level[i])
            gid = glob_of_local[p]
            sel = mask & (cmd == gid)
            nodes = np.asarray([node_of(cspec, b, level)
                                for b in np.asarray(tr.bank)[sel]])
            clks = np.asarray(tr.clk)[sel]
            ch = chan[sel]
            for key in {(int(c), int(n)) for c, n in zip(ch, nodes)}:
                t = np.sort(clks[(ch == key[0]) & (nodes == key[1])])
                if len(t) <= win:
                    continue
                slack = t[win:] - t[:-win] - lat
                for k in np.nonzero(slack < 0)[0]:
                    bad.append(
                        f"g{gi} ch{key[0]} node{key[1]} "
                        f"{cspec.cmd_names[p]} x{win + 1} within "
                        f"{int(t[k + win] - t[k])} < {lat}")
    return len(bad), bad


def starvation_bound(cspec, ccfg: C.ControllerConfig) -> int:
    maxlat = max(int(np.max(cspec.ct_lat)), 1)
    return (int(ccfg.queue_depth) + 2) * 2 * (maxlat + 16)


def check_starvation(system, tr, ccfg) -> tuple[int, list, dict]:
    """Served requests (final RD/WR with a recorded arrival) never wait
    past the bound, and the run made forward progress at all."""
    bad, waits = [], []
    cmd = np.asarray(tr.cmd)
    for gi, cspec, mask, local in _group_iter(system, tr):
        fx = np.asarray(cspec.cmd_fx)
        final_local = {i for i in range(int(cspec.n_cmds))
                       if fx[i] & (FX_FINAL_RD | FX_FINAL_WR)}
        final_glob = {g for g in range(len(local))
                      if int(local[g]) in final_local}
        bound = starvation_bound(cspec, ccfg)
        sel = mask & np.isin(cmd, sorted(final_glob)) & \
            (np.asarray(tr.arrive) >= 0)
        w = np.asarray(tr.clk)[sel] - np.asarray(tr.arrive)[sel]
        waits.extend(w.tolist())
        for k in np.nonzero(w > bound)[0]:
            bad.append(f"g{gi}: wait {int(w[k])} > bound {bound}")
    if not waits:
        bad.append("no request was ever served (vacuous run)")
    info = {"served": len(waits),
            "max_wait": int(max(waits)) if waits else -1}
    return len(bad), bad, info


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def run_stream(sim: Simulator, stream: F.ReplayStream, n_cycles: int):
    """Drive a replay stream through a Simulator, capture the trace."""
    _, dense = sim.run(n_cycles, trace=True)
    spec = sim.msys if not sim.msys.homogeneous else sim.cspec
    return capture(spec, dense, controller=sim.controller,
                   frontend=sim.frontend)


def verify_properties(system_args: dict, stream_kind: str, *,
                      n_cycles: int = 4000, seed: int = 0,
                      stream_kwargs: dict | None = None,
                      ccfg: C.ControllerConfig | None = None,
                      nrefi: int | None = None,
                      device: str | torch.device | None = None
                      ) -> PropertyReport:
    """Build the system, generate one adversarial stream, run it, and
    evaluate every invariant.

    ``system_args`` are Simulator kwargs minus controller/frontend/replay
    — e.g. ``dict(standard="DDR4", org_preset=..., timing_preset=...)``
    or ``dict(system=[...])``.  ``nrefi`` overrides the refresh interval
    (homogeneous path only) so refresh pressure fits a short horizon.
    ``device`` (``None`` = CUDA) runs the simulation.
    """
    ccfg = ccfg or C.ControllerConfig(queue_depth=8)
    args = dict(system_args)
    if nrefi is not None:
        args["timing_overrides"] = dict(args.get("timing_overrides") or {},
                                        nREFI=nrefi)
    probe_spec = Simulator(**args, device=device).msys
    system = probe_spec if not probe_spec.homogeneous \
        else probe_spec.groups[0].cspec
    stream = STREAMS[stream_kind](system, seed=seed,
                                  **(stream_kwargs or {}))
    sim = Simulator(**args, controller=ccfg,
                    frontend=F.FrontendConfig(pattern="trace", probes=False,
                                              stream=True),
                    replay=stream, device=device)
    tr = run_stream(sim, stream, n_cycles)

    checks, details, info = {}, [], {"stream": stream_kind,
                                     "n_requests": len(stream),
                                     "n_commands": len(tr.clk)}
    # 1) full timing + scheduler audit (per group for hetero)
    rep = _audit(system, tr, check_fingerprint=False)
    checks["audit_clean"] = len(rep.violations)
    details += [f"audit: {v}" for v in rep.violations[:8]]
    # 2) refresh deadline
    n, det, extra = check_refresh_deadline(system, tr, ccfg)
    checks["refresh_deadline"] = n
    details += det[:8]
    info.update(extra)
    # 3) independent tFAW-style window re-check
    n, det = check_faw_windows(system, tr)
    checks["faw_window"] = n
    details += det[:8]
    # 4) starvation / progress
    n, det, extra = check_starvation(system, tr, ccfg)
    checks["starvation_bound"] = n
    details += det[:8]
    info.update(extra)

    name = system_args.get("standard") or "hetero"
    return PropertyReport(name=f"{name}/{stream_kind}", checks=checks,
                          details=details, info=info)
