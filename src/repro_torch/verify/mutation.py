"""Mutation-sensitivity matrix for the trace auditor.

``repro_torch.trace.audit`` (the port's copy of ``repro.trace.audit``)
is the gatekeeper for every golden trace the engine emits; this module asks the converse question — *does the
auditor actually catch violations?* — by injecting single-cycle timing
violations into legal command streams, one per constraint class:

* ``pairwise``  — a plain two-command latency row (window == 1),
* ``window``    — a sliding-window row (tFAW-style, window > 1),
* ``refresh``   — a row anchored on the all-bank refresh command.

Each injection is engineered so the violated row's slack is exactly
``-1`` (one cycle early), the hardest-to-detect violation, and the
matrix asserts the auditor reports THAT row (matched by previous/next
command, latency, and window) — a 100%-detection requirement across
constraint classes and standards.

Injections mutate a legal trace in one of two ways: in-place (retime an
existing command pair, like the hand-written DDR4 tests this module
generalizes) or by appending a quiescent-tail pair — two commands added
after a long idle gap so the injected pair is the only new timing
relation that matters.  Appending realizes every class on every
standard regardless of what a finite golden run happened to exercise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.spec import KIND_REF
from repro_torch.trace.audit import audit as _audit, constraint_name
from repro_torch.trace.capture import CommandTrace

from .explore import node_of


# ---------------------------------------------------------------------------
# Trace surgery helpers
# ---------------------------------------------------------------------------

_COLS = ("clk", "cmd", "bank", "row", "bus", "arrive", "hit_ready")


def _reorder_by_clk(tr: CommandTrace) -> CommandTrace:
    order = np.argsort(tr.clk, kind="stable")
    cols = {f: getattr(tr, f)[order] for f in _COLS}
    for f in ("chan", "group"):
        if getattr(tr, f) is not None:
            cols[f] = getattr(tr, f)[order]
    return dataclasses.replace(tr, **cols)


def _append(tr: CommandTrace, rows: list[dict]) -> CommandTrace:
    """Append events (dicts over _COLS) and re-sort; extends n_cycles."""
    cols = {}
    for f in _COLS:
        add = np.asarray([r[f] for r in rows], np.int32)
        cols[f] = np.concatenate([getattr(tr, f), add])
    for f in ("chan", "group"):
        if getattr(tr, f) is not None:
            cols[f] = np.concatenate(
                [getattr(tr, f), np.zeros(len(rows), np.int32)])
    n_cycles = max(int(tr.n_cycles), int(cols["clk"].max()) + 1)
    return _reorder_by_clk(dataclasses.replace(tr, n_cycles=n_cycles,
                                               **cols))


def _ev(clk, cmd, bank=0, row=0):
    return dict(clk=int(clk), cmd=int(cmd), bank=int(bank), row=int(row),
                bus=0, arrive=-1, hit_ready=0)


# ---------------------------------------------------------------------------
# Constraint-class row selection
# ---------------------------------------------------------------------------

def _rows_of_class(cspec, klass: str) -> list[int]:
    """Eligible constraint-table rows for one mutation class, best-first
    (largest latency first — the most head-room for clean injection)."""
    names = list(cspec.cmd_names)
    kind = np.asarray(cspec.cmd_kind)
    out = []
    for i in range(len(cspec.ct_prev)):
        p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
        lat, win = int(cspec.ct_lat[i]), int(cspec.ct_win[i])
        if lat < 2 or int(cspec.ct_level[i]) > int(cspec.cmd_scope[p]):
            continue
        is_ref = (kind[p] == KIND_REF) or (kind[f] == KIND_REF) \
            or "REF" in names[p] or "REF" in names[f]
        if klass == "pairwise" and win == 1 and not is_ref:
            out.append(i)
        elif klass == "window" and win > 1:
            out.append(i)
        elif klass == "refresh" and win == 1 and is_ref:
            out.append(i)
    return sorted(out, key=lambda i: -int(cspec.ct_lat[i]))


@dataclasses.dataclass
class Injection:
    """One injected single-cycle violation and how to recognize it."""
    klass: str
    row: int                  # constraint-table row index
    prev: str
    next: str
    lat: int
    win: int
    mode: str                 # "inplace" | "append"
    trace: CommandTrace

    @property
    def constraint(self) -> str:
        return f"lat={self.lat}" + (f" [window={self.win}]"
                                    if self.win > 1 else "")


def detected(cspec, inj: Injection, report=None) -> bool:
    """Audit the mutated trace; True iff the injected row is flagged at
    slack -1 (previous/next commands, latency and window all match)."""
    rep = report or _audit(cspec, inj.trace, check_fingerprint=False)
    want_name = constraint_name(cspec, inj.row)
    return any(v.prev_cmd == inj.prev and v.cmd == inj.next
               and v.slack == -1 and v.constraint == want_name
               for v in rep.violations)


# ---------------------------------------------------------------------------
# Injections
# ---------------------------------------------------------------------------

def _inject_inplace_pairwise(cspec, tr, i) -> CommandTrace | None:
    """Retime an existing (prev, next) pair at the same constraint node
    to slack -1 — the generalization of the hand-written ACT->RD test."""
    p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
    lat, level = int(cspec.ct_lat[i]), int(cspec.ct_level[i])
    if tr.chan is not None and len(np.unique(tr.chan)) > 1:
        return None                       # in-place surgery: 1-channel only
    prev_idx = np.nonzero(tr.cmd == p)[0]
    if not len(prev_idx):
        return None
    nodes = np.asarray([node_of(cspec, b, level) for b in tr.bank])
    for j in np.nonzero(tr.cmd == f)[0]:
        before = prev_idx[(tr.clk[prev_idx] < tr.clk[j])
                          & (nodes[prev_idx] == nodes[j])]
        if not len(before):
            continue
        a = before[np.argmax(tr.clk[before])]     # most recent prev
        target = int(tr.clk[a]) + lat - 1
        if target <= int(tr.clk[a]) or target >= int(tr.clk[j]):
            continue                              # must move strictly earlier
        clk = tr.clk.copy()
        clk[j] = target
        return _reorder_by_clk(dataclasses.replace(tr, clk=clk))
    return None


def _inject_append_pairwise(cspec, tr, i) -> CommandTrace:
    """Quiescent-tail injection: prev at t0 (far past all activity),
    next at t0 + lat - 1."""
    p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
    lat = int(cspec.ct_lat[i])
    gap = 2 * max(int(np.max(cspec.ct_lat)), 1) + 8
    t0 = int(tr.clk.max()) + gap
    return _append(tr, [_ev(t0, p), _ev(t0 + lat - 1, f)])


def _inject_append_window(cspec, tr, i) -> CommandTrace | None:
    """tFAW-style: ``win`` legally-spaced prev commands on DISTINCT
    banks of the same window node (so per-bank cycle constraints like
    nRC never bind), then the following command on a fresh bank one
    cycle inside the closing window."""
    p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
    lat, win = int(cspec.ct_lat[i]), int(cspec.ct_win[i])
    level = int(cspec.ct_level[i])
    nb = int(cspec.n_banks)
    if nb <= win:
        return None                      # not enough banks to spread over
    banks = list(range(win))
    vbank = win                          # violator on a bank not used above
    # deepest level every participant still shares a node at: only
    # pairwise rows at those levels constrain the cross-bank spacing
    shared = 0
    for lvl in range(len(cspec.level_counts)):
        if len({node_of(cspec, b, lvl) for b in banks + [vbank]}) == 1:
            shared = lvl
        else:
            break
    if shared < level:
        return None                      # participants leave the window node
    spacing = 1
    for j in range(len(cspec.ct_prev)):
        if int(cspec.ct_win[j]) == 1 and int(cspec.ct_prev[j]) == p \
                and int(cspec.ct_next[j]) in (p, f) \
                and int(cspec.ct_level[j]) <= shared:
            spacing = max(spacing, int(cspec.ct_lat[j]))
    gap = 2 * max(int(np.max(cspec.ct_lat)), 1) + 8
    t0 = int(tr.clk.max()) + gap
    # the violator's window-th most recent prev is t0 -> earliest legal
    # issue is t0 + lat; go one cycle early (strictly after every prev)
    t_bad = t0 + lat - 1
    if t_bad <= t0 + (win - 1) * spacing:
        return None                      # window not binding at this spacing
    rows = [_ev(t0 + k * spacing, p, bank=banks[k]) for k in range(win)]
    rows.append(_ev(t_bad, f, bank=vbank))
    return _append(tr, rows)


def _inject_append_refresh(cspec, tr, i) -> CommandTrace:
    """REFab-anchored: refresh at t0, the constrained follower one cycle
    inside the recovery latency."""
    p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
    lat = int(cspec.ct_lat[i])
    gap = 2 * max(int(np.max(cspec.ct_lat)), 1) + 8
    t0 = int(tr.clk.max()) + gap
    return _append(tr, [_ev(t0, p, row=-1), _ev(t0 + lat - 1, f)])


CLASSES = ("pairwise", "window", "refresh")


def inject(cspec, tr: CommandTrace, klass: str) -> Injection | None:
    """Inject one slack -1 violation of ``klass`` into a legal trace.
    Returns None when the standard has no eligible constraint row."""
    for i in _rows_of_class(cspec, klass):
        names = list(cspec.cmd_names)
        mutated = None
        mode = "append"
        if klass == "pairwise":
            mutated = _inject_inplace_pairwise(cspec, tr, i)
            mode = "inplace"
            if mutated is None:
                mutated = _inject_append_pairwise(cspec, tr, i)
                mode = "append"
        elif klass == "window":
            mutated = _inject_append_window(cspec, tr, i)
        elif klass == "refresh":
            mutated = _inject_append_refresh(cspec, tr, i)
        else:
            raise ValueError(f"unknown mutation class {klass!r}")
        if mutated is None:
            continue
        return Injection(klass=klass, row=i,
                         prev=names[int(cspec.ct_prev[i])],
                         next=names[int(cspec.ct_next[i])],
                         lat=int(cspec.ct_lat[i]),
                         win=int(cspec.ct_win[i]), mode=mode, trace=mutated)
    return None


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

def mutation_matrix(traces: dict, classes=CLASSES) -> dict:
    """``traces`` maps standard -> (cspec, legal CommandTrace).  Returns
    {(standard, class): "detected" | "MISSED:<...>" | "skipped:<...>"}."""
    out = {}
    for std, (cspec, tr) in traces.items():
        for klass in classes:
            inj = inject(cspec, tr, klass)
            if inj is None:
                out[(std, klass)] = "skipped: no eligible constraint row"
                continue
            if detected(cspec, inj):
                out[(std, klass)] = "detected"
            else:
                out[(std, klass)] = (f"MISSED: {inj.prev}->{inj.next} "
                                     f"{inj.constraint} ({inj.mode})")
    return out


def matrix_table(matrix: dict) -> str:
    """Render the detection matrix as markdown."""
    stds = sorted({k[0] for k in matrix})
    classes = [c for c in CLASSES if any(k[1] == c for k in matrix)]
    lines = ["| standard | " + " | ".join(classes) + " |",
             "|---|" + "---|" * len(classes)]
    for s in stds:
        cells = [matrix.get((s, c), "-") for c in classes]
        lines.append(f"| {s} | " + " | ".join(cells) + " |")
    return "\n".join(lines)
