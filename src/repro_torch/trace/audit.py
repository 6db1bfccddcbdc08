"""Trace auditing: vectorized replay of a captured command trace against the
compiled constraint table, plus scheduler-behavior invariants.

The port's copy of ``repro.trace.audit`` (numpy over the port's
``CommandTrace``; its reports equal the reference's for the same trace).

This is the "fine-grained validation" pillar of the paper (§4.2) in
post-hoc form, following the re-evaluation methodology of Bostancı et al.:
instead of trusting the engine's in-loop timing checks, an *independent*
replay walks the captured command stream and re-derives, for every issued
command, the earliest cycle each timing constraint would have allowed it —
any command that issued early is reported with the exact violated
constraint, the preceding command issue it raced, and the (negative) slack.

The replay is fully vectorized: no Python loop over cycles or commands.
For each constraint ``(prev, next, level, lat, window)`` the preceding
events are bucketed by their *channel-qualified* level-``level`` hierarchy
node (``chan * num_nodes + node``; the node is a division of the flat bank
id — the trace's issue order is already time-sorted), and one
``searchsorted`` per constraint locates, for every following event, the
``window``-th most recent preceding event at the same node.  Multi-channel
traces are thereby audited per channel in the same vectorized pass —
commands on different channels never constrain each other — and the
report carries an explicit per-channel violation count (``by_channel``).
Heterogeneous traces (``group`` column, npz v3) are split by spec group
first: every channel replays against its OWN group's constraint table
(merged command ids mapped back to the group's local namespace), and the
report additionally carries a per-group count (``by_group``).  Cost is
O(n_constraints · N log N) for N commands, independent of cycle count and
channel count.

Scheduler checks replay two invariants of the modeled schedulers over the
request information embedded in the trace:

* **row-hit-first** (FR-FCFS): whenever a post-predicate row-hit candidate
  existed (the engine records this per selection pass as ``hit_ready``),
  the issued queue command must be a column/sync command — FR-FCFS never
  spends the slot on a row command while a ready hit waits;
* **age order**: among served column commands to the same (bank, row,
  command), request arrival times must be non-decreasing — both FCFS and
  FR-FCFS pick the oldest among equally-maskable candidates.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import spec as S
from repro_torch.core.compile import CompiledSpec, MemorySystemSpec
from repro_torch.trace.capture import CommandTrace, spec_fingerprint_hex


@dataclasses.dataclass
class Violation:
    """One audit finding.  ``slack`` is issue clock minus earliest legal
    clock — negative means the command issued ``-slack`` cycles early.
    ``chan`` is the memory-system channel the command issued on and
    ``group`` its spec group (0 for homogeneous systems)."""
    check: str          # "timing" | "scheduler"
    constraint: str     # e.g. "ACT->RD @ bank lat=22" or "row_hit_first"
    clk: int            # cycle the offending command issued
    cmd: str
    bank: int
    bus: int
    prev_cmd: str = ""
    prev_clk: int = -1
    slack: int = 0
    chan: int = 0
    group: int = 0

    def __str__(self):
        s = (f"[{self.check}] {self.constraint}: {self.cmd} @ clk "
             f"{self.clk} ch {self.chan} bank {self.bank}")
        if self.prev_cmd:
            s += f" after {self.prev_cmd} @ clk {self.prev_clk}"
        if self.slack:
            s += f" (slack {self.slack})"
        return s


@dataclasses.dataclass
class AuditReport:
    n_commands: int
    n_pairs_checked: int            # (preceding, following) pairs examined
    checks: dict                    # check name -> violation count
    violations: list                # list[Violation], possibly truncated
    truncated: bool = False
    #: channel -> total violation count (every audited channel appears,
    #: so a clean multi-channel report shows an explicit zero per channel)
    by_channel: dict = dataclasses.field(default_factory=dict)
    #: spec group -> total violation count (heterogeneous systems: every
    #: group appears, each replayed against its OWN constraint table)
    by_group: dict = dataclasses.field(default_factory=dict)
    #: spec group -> display label ("DDR5", "DDR4@ll80", ...)
    group_labels: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return sum(self.checks.values()) == 0

    @property
    def n_violations(self) -> int:
        return sum(self.checks.values())

    def summary(self) -> str:
        head = (f"audited {self.n_commands} commands, "
                f"{self.n_pairs_checked} constraint pairs: ")
        if self.ok:
            tail = "clean"
        else:
            parts = [f"{n} {name}" for name, n in sorted(self.checks.items())
                     if n]
            tail = f"{self.n_violations} violations ({', '.join(parts)})"
        if len(self.by_group) > 1:
            per = ", ".join(
                f"g{g} {self.group_labels.get(g, '')}: {n}".replace("  ", " ")
                for g, n in sorted(self.by_group.items()))
            tail += f" [{per}]"
        if len(self.by_channel) > 1:
            per = ", ".join(f"ch{c}: {n}"
                            for c, n in sorted(self.by_channel.items()))
            tail += f" [{per}]"
        return head + tail


def constraint_name(cspec: CompiledSpec, i: int) -> str:
    """Human-readable identity of constraint-table row ``i``."""
    p = cspec.cmd_names[int(cspec.ct_prev[i])]
    f = cspec.cmd_names[int(cspec.ct_next[i])]
    lv = cspec.levels[int(cspec.ct_level[i])]
    name = f"{p}->{f} @ {lv} lat={int(cspec.ct_lat[i])}"
    if int(cspec.ct_win[i]) > 1:
        name += f" window={int(cspec.ct_win[i])}"
    return name


def _nodes_at(cspec: CompiledSpec, level: int, bank: np.ndarray) -> np.ndarray:
    """Level-``level`` hierarchy-node id for events at flat bank ids."""
    if level == 0:
        return np.zeros(bank.shape, np.int64)
    denom = int(np.prod(cspec.level_counts[level + 1:], dtype=np.int64))
    return int(cspec.level_offsets[level]) + bank.astype(np.int64) // denom


def _audit_timing(cspec: CompiledSpec, trace: CommandTrace, violations: list,
                  max_violations: int, by_channel: np.ndarray):
    """Replay every constraint-table row over the trace.  Hierarchy nodes
    are channel-qualified (``chan * num_nodes + node``): every constraint
    is replayed independently per memory-system channel, and commands on
    different channels never constrain each other.  Returns
    (n_violations, n_pairs_checked)."""
    N = len(trace)
    cmd = trace.cmd.astype(np.int64)
    bank = trace.bank.astype(np.int64)
    clk = trace.clk.astype(np.int64)
    chan = trace.chan.astype(np.int64)
    order = np.arange(N, dtype=np.int64)
    names = trace.cmd_names
    n_viol = 0
    n_pairs = 0
    for i in range(len(cspec.ct_prev)):
        p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
        level, lat = int(cspec.ct_level[i]), int(cspec.ct_lat[i])
        win = int(cspec.ct_win[i])
        if level > int(cspec.cmd_scope[p]):
            continue        # preceding command never stamps this level
        p_sel = np.nonzero(cmd == p)[0]
        f_sel = np.nonzero(cmd == f)[0]
        if len(p_sel) == 0 or len(f_sel) == 0:
            continue
        p_nodes = chan[p_sel] * cspec.num_nodes \
            + _nodes_at(cspec, level, bank[p_sel])
        f_nodes = chan[f_sel] * cspec.num_nodes \
            + _nodes_at(cspec, level, bank[f_sel])
        # bucket preceding events by node, keeping issue order inside each
        # bucket: composite key = node * (N+1) + order (order < N+1)
        key_p = p_nodes * (N + 1) + order[p_sel]
        sort = np.argsort(key_p, kind="stable")
        key_p = key_p[sort]
        clk_p = clk[p_sel][sort]
        # position of each following event inside its node's bucket
        query = f_nodes * (N + 1) + order[f_sel]
        pos = np.searchsorted(key_p, query)      # p events strictly before
        j = pos - win                            # window-th most recent
        valid = j >= 0
        same_node = np.zeros(len(f_sel), bool)
        same_node[valid] = (key_p[j[valid]] // (N + 1)) == f_nodes[valid]
        valid &= same_node
        n_pairs += int(np.count_nonzero(valid))
        t_prev = np.where(valid, clk_p[np.clip(j, 0, None)], np.int64(-1))
        early = valid & (clk[f_sel] < t_prev + lat)
        if not early.any():
            continue
        cname = constraint_name(cspec, i)
        np.add.at(by_channel, chan[f_sel][early], 1)
        for k in np.nonzero(early)[0]:
            n_viol += 1
            if len(violations) < max_violations:
                e = int(f_sel[k])
                violations.append(Violation(
                    check="timing", constraint=cname,
                    clk=int(clk[e]), cmd=names[int(cmd[e])],
                    bank=int(bank[e]), bus=int(trace.bus[e]),
                    prev_cmd=names[p], prev_clk=int(t_prev[k]),
                    slack=int(clk[e] - (t_prev[k] + lat)),
                    chan=int(chan[e])))
    return n_viol, n_pairs


def _audit_row_hit_first(cspec: CompiledSpec, trace: CommandTrace,
                         violations: list, max_violations: int,
                         by_channel: np.ndarray) -> int:
    """FR-FCFS invariant: when a maskable row hit existed, the issued queue
    command must be a column (or data-clock sync) command.  The engine
    records ``hit_ready`` per (channel, bus-slot) selection pass, so the
    check is channel-local by construction."""
    kind = np.asarray(cspec.cmd_kind)[trace.cmd]
    queue_issued = trace.arrive >= 0
    is_col = (kind == S.KIND_COL) | (kind == S.KIND_SYNC)
    bad = queue_issued & (trace.hit_ready != 0) & ~is_col
    names = trace.cmd_names
    np.add.at(by_channel, trace.chan[bad].astype(np.int64), 1)
    for e in np.nonzero(bad)[0]:
        if len(violations) < max_violations:
            violations.append(Violation(
                check="scheduler", constraint="row_hit_first",
                clk=int(trace.clk[e]), cmd=names[int(trace.cmd[e])],
                bank=int(trace.bank[e]), bus=int(trace.bus[e]),
                chan=int(trace.chan[e])))
    return int(np.count_nonzero(bad))


def _audit_age_order(cspec: CompiledSpec, trace: CommandTrace,
                     violations: list, max_violations: int,
                     by_channel: np.ndarray) -> int:
    """Served column commands to one (channel, bank, row, command) must
    serve requests in arrival order — each channel's controller schedules
    independently, so age order only binds within a channel."""
    fx = np.asarray(cspec.cmd_fx)[trace.cmd]
    final = (fx & (S.FX_FINAL_RD | S.FX_FINAL_WR)) != 0
    sel = np.nonzero(final & (trace.arrive >= 0))[0]
    if len(sel) < 2:
        return 0
    # stable sort by (chan, bank, row, cmd) keeps issue order per group
    keys = np.lexsort((sel, trace.cmd[sel], trace.row[sel],
                       trace.bank[sel], trace.chan[sel]))
    s = sel[keys]
    same = ((trace.chan[s][1:] == trace.chan[s][:-1])
            & (trace.bank[s][1:] == trace.bank[s][:-1])
            & (trace.row[s][1:] == trace.row[s][:-1])
            & (trace.cmd[s][1:] == trace.cmd[s][:-1]))
    regress = same & (trace.arrive[s][1:] < trace.arrive[s][:-1])
    names = trace.cmd_names
    np.add.at(by_channel, trace.chan[s][1:][regress].astype(np.int64), 1)
    for k in np.nonzero(regress)[0]:
        if len(violations) < max_violations:
            e, prev = int(s[k + 1]), int(s[k])
            violations.append(Violation(
                check="scheduler", constraint="age_order",
                clk=int(trace.clk[e]), cmd=names[int(trace.cmd[e])],
                bank=int(trace.bank[e]), bus=int(trace.bus[e]),
                prev_cmd=names[int(trace.cmd[prev])],
                prev_clk=int(trace.clk[prev]),
                slack=int(trace.arrive[e] - trace.arrive[prev]),
                chan=int(trace.chan[e])))
    return int(np.count_nonzero(regress))


def _audit_one_spec(cspec: CompiledSpec, trace: CommandTrace,
                    scheduler: str | None, max_violations: int):
    """Run the three checks of one homogeneous (sub-)trace against one
    constraint table.  Returns (checks, n_pairs, violations, ch_counts)."""
    n_channels = max(int(getattr(cspec, "n_channels", 1)),
                     int(trace.chan.max()) + 1 if len(trace) else 1)
    ch_counts = np.zeros(n_channels, np.int64)
    violations: list = []
    checks = {}
    checks["timing"], n_pairs = _audit_timing(cspec, trace, violations,
                                              max_violations, ch_counts)

    has_requests = bool(np.any(trace.arrive >= 0))
    if has_requests and scheduler == "FRFCFS":
        checks["row_hit_first"] = _audit_row_hit_first(
            cspec, trace, violations, max_violations, ch_counts)
    if has_requests and scheduler in ("FRFCFS", "FCFS"):
        checks["age_order"] = _audit_age_order(cspec, trace, violations,
                                               max_violations, ch_counts)
    return checks, n_pairs, violations, ch_counts


def _audit_system(msys: MemorySystemSpec, trace: CommandTrace,
                  scheduler: str | None,
                  max_violations: int) -> AuditReport:
    """Heterogeneous audit: each spec group's commands are carved out of
    the system trace (``group`` column), mapped back from the merged
    command namespace into the group's local ids, and replayed against
    the group's OWN constraint table — commands on different groups (or
    different channels of one group) never constrain each other.  Channel
    attribution in the merged report is system-wide."""
    n_names = len(trace.cmd_names)
    checks: dict = {}
    n_pairs = 0
    violations: list = []
    ch_counts = np.zeros(msys.n_channels, np.int64)
    by_group: dict = {}
    labels: dict = {}
    for g, grp in enumerate(msys.groups):
        base = int(msys.chan_base[g])
        labels[g] = grp.cspec.standard or grp.cspec.name
        if grp.link_latency:
            labels[g] += f"@ll{grp.link_latency}"
        m = np.nonzero(trace.group == g)[0]
        # merged-id -> group-local-id map; commands of other groups never
        # appear under this group's mask, so -1 entries are unreachable
        to_local = np.full(n_names, -1, np.int64)
        to_local[msys.group_cmd_maps[g]] = np.arange(
            len(msys.group_cmd_maps[g]))
        local_cmd = to_local[trace.cmd[m]]
        if np.any(local_cmd < 0):
            raise ValueError(
                f"trace rows of group {g} carry command ids outside the "
                "group's namespace — group column and cmd ids disagree")
        sub = CommandTrace(
            clk=trace.clk[m], cmd=local_cmd.astype(np.int32),
            bank=trace.bank[m], row=trace.row[m], bus=trace.bus[m],
            arrive=trace.arrive[m], hit_ready=trace.hit_ready[m],
            chan=(trace.chan[m] - base).astype(np.int32),
            n_cycles=trace.n_cycles, cmd_names=list(grp.cspec.cmd_names),
            meta=dict(trace.meta, n_channels=grp.channels))
        g_checks, g_pairs, g_viols, g_counts = _audit_one_spec(
            grp.cspec, sub, scheduler, max_violations - len(violations))
        for v in g_viols:
            v.chan += base
            v.group = g
        violations.extend(g_viols)
        n_pairs += g_pairs
        for k, n in g_checks.items():
            checks[k] = checks.get(k, 0) + n
        by_group[g] = int(sum(g_checks.values()))
        ch_counts[base:base + grp.channels] += g_counts[:grp.channels]
    total = sum(checks.values())
    return AuditReport(n_commands=len(trace), n_pairs_checked=n_pairs,
                       checks=checks, violations=violations,
                       truncated=total > len(violations),
                       by_channel={c: int(n)
                                   for c, n in enumerate(ch_counts)},
                       by_group=by_group, group_labels=labels)


def audit(spec, trace: CommandTrace, *,
          check_fingerprint: bool = True, scheduler: str | None = None,
          max_violations: int = 256) -> AuditReport:
    """Audit a captured trace against its constraint table(s).

    ``spec`` may be a :class:`CompiledSpec`, a heterogeneous
    :class:`repro_torch.core.compile.MemorySystemSpec` (each channel is then
    replayed against its own group's constraint table), or None — the
    spec/system is then recompiled from the trace's embedded provenance.
    When ``check_fingerprint`` is set (default), a provided spec must
    match the fingerprint the trace was captured under.  ``scheduler``
    defaults to the controller scheduler recorded in the trace metadata;
    the row-hit-first check only applies to FR-FCFS.
    """
    if spec is None:
        spec = trace.compiled_system() if trace.n_groups > 1 \
            else trace.compiled_spec()
    elif check_fingerprint and trace.fingerprint:
        got = spec_fingerprint_hex(spec)
        if got != trace.fingerprint:
            raise ValueError(
                f"spec fingerprint {got} does not match trace fingerprint "
                f"{trace.fingerprint}; audit would be meaningless "
                "(pass check_fingerprint=False to override)")

    if scheduler is None:
        scheduler = trace.meta.get("controller", {}).get("scheduler")

    if isinstance(spec, MemorySystemSpec):
        if spec.n_groups > 1:
            return _audit_system(spec, trace, scheduler, max_violations)
        spec = spec.groups[0].cspec
    cspec = spec

    checks, n_pairs, violations, ch_counts = _audit_one_spec(
        cspec, trace, scheduler, max_violations)
    total = sum(checks.values())
    return AuditReport(n_commands=len(trace), n_pairs_checked=n_pairs,
                       checks=checks, violations=violations,
                       truncated=total > len(violations),
                       by_channel={c: int(n)
                                   for c, n in enumerate(ch_counts)},
                       by_group={0: total})
