"""Bounded-depth exhaustive exploration of the controller against the
scalar oracle.

The port's counterpart of ``repro.verify.explore``.  For tiny device
geometries (one bank group, two banks, a 2–4 deep queue) the reachable
state space of the controller step under a small request-injection
alphabet is small enough to enumerate breadth-first to a depth bound.
Every command the port's controller issues along ANY reachable path is
cross-checked against the scalar numpy oracle
(:class:`repro_torch.core.dut.DeviceUnderTest`) with ``check=True`` — an
independent re-derivation of prerequisite and timing legality — and
(optionally) the full earliest-ready table of every unique state is
compared entry-for-entry against ``DeviceUnderTest.earliest``.

The transition is one batched step over a chunk of ``chunk`` lanes at
one clock: the queue insert, then ``controller.controller_step`` (the
fused controller-step kernel on CUDA tensors, the plain step on CPU
tensors), then ``device.earliest_ready_table`` (the readiness kernel on
CUDA tensors).  The frontier stays on the host as numpy trees: each
chunk is stacked, sent to the device once, stepped, and its children,
events and tables come back before the next launch overwrites them.

A divergence yields a counterexample: the injection path is shrunk by
greedy delta-debugging (replace injections with no-ops while the
failure persists, then truncate at the failing cycle) and the minimized
command prefix is exported as a replayable ``CommandTrace`` ``.npz``
artifact that ``repro_torch.trace.audit`` and :func:`load_counterexample`
(of either package) can consume without this module in the loop.

The exploration is exhaustive over the injection alphabet up to
``depth`` (modulo state dedup, which is sound: identical controller
state at the same cycle ⇒ identical futures) with an explicit
``max_frontier`` cap — when the cap trips the result says so via
``truncated`` instead of silently under-covering.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import controller as C
from repro_torch.core import device as D
from repro_torch.core.compile import compile_spec
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.dut import DeviceUnderTest
from repro_torch.core.spec import Organization, get_standard
from repro_torch.core.standards import DEFAULT_SYSTEMS
from repro_torch.trace import format as TF
from repro_torch.trace.capture import (CommandTrace, base_meta,
                                       spec_fingerprint_hex)


# ---------------------------------------------------------------------------
# Tiny device geometries
# ---------------------------------------------------------------------------

#: conservative fast-timing overrides for exploration: every key present
#: in a standard's timing preset is shrunk so interesting command
#: interleavings (activate/precharge churn, refresh) fit inside a small
#: depth bound.  Engine and oracle compile from the SAME overridden
#: preset, so the cross-check is unaffected — this only densifies the
#: reachable behaviors per cycle of depth.
FAST_TIMINGS = {
    "nRCD": 4, "nRCDRD": 4, "nRCDWR": 5, "nRP": 4, "nRPab": 5, "nRPpb": 4,
    "nRAS": 8, "nRC": 12, "nCL": 4, "nCWL": 3, "nRL": 4, "nWL": 3,
    "nBL": 2, "nCCD": 2, "nCCDS": 2, "nCCDL": 3, "nCCDMIN": 2,
    "nRRD": 2, "nRRDS": 2, "nRRDL": 3, "nWR": 4, "nRTP": 3, "nPPD": 2,
    "nFAW": 10, "nREFI": 48, "nRFC": 12, "nRFCab": 12, "nRFCpb": 8,
    "nRTRS": 2, "nWTRS": 2, "nWTRL": 3, "nWTR": 3, "nCS": 1,
}


def tiny_spec(standard: str, *, banks: int = 2, rows: int = 8,
              columns: int = 8, fast: bool = False, nrefi: int | None = None,
              timing_overrides: dict | None = None):
    """Compile ``standard`` at a tiny organization: every hierarchy level
    below the channel collapsed to one node except the bank level, which
    gets ``banks`` banks.

    The tiny organization is attached to an UNREGISTERED subclass of the
    standard (org preset name ``"TINY"``), so the registry and every
    other consumer of the real presets are untouched.  ``fast=True``
    applies :data:`FAST_TIMINGS` (key-intersected with the preset);
    ``nrefi`` force-overrides the refresh interval on top.
    """
    std = get_standard(standard)
    org_name, tim_name = DEFAULT_SYSTEMS[std.name]
    base_org = std.org_presets[org_name]
    counts = {lv: 1 for lv in std.levels[1:]}
    counts[std.levels[-1]] = banks
    tiny_org = Organization(density_mb=base_org.density_mb, dq=base_org.dq,
                            counts=counts, rows=rows, columns=columns)
    tiny_std = type(std.__name__, (std,),
                    {"org_presets": dict(std.org_presets, TINY=tiny_org)})
    overrides = {}
    if fast:
        preset = std.timing_presets[tim_name]
        overrides.update({k: v for k, v in FAST_TIMINGS.items()
                          if k in preset})
    if timing_overrides:
        overrides.update(timing_overrides)
    if nrefi is not None:
        overrides["nREFI"] = nrefi
    return compile_spec(tiny_std, "TINY", tim_name, overrides or None)


# ---------------------------------------------------------------------------
# Address helpers (flat bank id <-> per-level indices)
# ---------------------------------------------------------------------------

def bank_sub(cspec, bank: int) -> np.ndarray:
    """Flat bank id -> per-level sub indices below the channel."""
    counts = [int(c) for c in cspec.level_counts]
    idxs, b = [], int(bank)
    for i in range(len(counts) - 1, 0, -1):
        idxs.append(b % counts[i])
        b //= counts[i]
    return np.asarray(idxs[::-1], np.int32)


def addr_from_bank(cspec, bank: int, row: int) -> dict:
    """Flat bank id + row -> the oracle's address dict."""
    sub = bank_sub(cspec, bank)
    addr = {lv: int(v) for lv, v in zip(cspec.levels[1:], sub)}
    addr["row"] = int(row) if row >= 0 else 0
    addr["col"] = 0
    return addr


def node_of(cspec, bank: int, level: int) -> int:
    """Ancestor node index (within the channel) of a flat bank at a
    hierarchy level — events share a constraint node iff this matches."""
    div = 1
    for i in range(level + 1, len(cspec.level_counts)):
        div *= int(cspec.level_counts[i])
    return int(bank) // div


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Divergence:
    """One disagreement between the port's controller and the oracle."""
    kind: str                 # "illegal_issue" | "earliest_mismatch"
    depth: int                # cycle at which it was observed
    cmd: str
    bank: int
    row: int
    detail: str
    path: tuple               # injection-choice indices, one per cycle

    def __str__(self):
        return (f"[{self.kind}] clk={self.depth} {self.cmd} "
                f"bank={self.bank} row={self.row}: {self.detail}")


@dataclasses.dataclass
class Counterexample:
    """A minimized failing injection path and its replayable trace."""
    path: tuple
    divergence: Divergence
    trace: CommandTrace
    artifact: str | None = None


@dataclasses.dataclass
class ExploreResult:
    standard: str
    depth: int
    states_explored: int      # unique states kept across all layers
    edges: int                # (state, injection) transitions evaluated
    commands_checked: int     # oracle-checked issued commands
    tables_checked: int       # earliest-ready tables compared in full
    truncated: bool           # frontier cap trimmed the search
    divergences: list
    counterexample: Counterexample | None = None

    @property
    def ok(self) -> bool:
        return not self.divergences

    def __str__(self):
        status = "ok" if self.ok else f"{len(self.divergences)} divergence(s)"
        extra = " [truncated]" if self.truncated else ""
        return (f"explore[{self.standard}] depth={self.depth} "
                f"states={self.states_explored} edges={self.edges} "
                f"cmds={self.commands_checked} tables={self.tables_checked}"
                f"{extra}: {status}")


# ---------------------------------------------------------------------------
# Injection alphabet
# ---------------------------------------------------------------------------

def default_alphabet(cspec) -> tuple:
    """Per-cycle injection choices: index 0 MUST be the no-op (the
    minimizer shrinks toward it).  Entries are (bank, row, is_write)."""
    nb = int(cspec.n_banks)
    return (None,
            (0, 0, False),            # same-bank same-row (hit pressure)
            (0, 1, False),            # same-bank other-row (conflict)
            (nb - 1, 0, True))        # far bank write (turnaround)


def _encode_alphabet(cspec, alphabet):
    if alphabet[0] is not None:
        raise ValueError("alphabet[0] must be None (the no-op injection)")
    L = len(cspec.levels) - 1
    want = np.asarray([a is not None for a in alphabet])
    wr = np.asarray([bool(a[2]) if a else False for a in alphabet])
    sub = np.stack([bank_sub(cspec, a[0]) if a else np.zeros(L, np.int32)
                    for a in alphabet]).astype(np.int32)
    row = np.asarray([a[1] if a else 0 for a in alphabet], np.int32)
    return want, wr, sub, row


# ---------------------------------------------------------------------------
# The batched transition: inject one request, step the controller
# ---------------------------------------------------------------------------

class _Step:
    """The exploration transition of one (spec, config) on one device:
    ``(states, injections, clk) -> (states', events, earliest tables)``
    over ``P`` lanes, each a one-channel controller at the clock ``clk``.
    Mirrors the engine's per-cycle order exactly — the frontend inserts
    into the queue first, the controller steps second — then reads the
    dense earliest-ready table of every lane.

    States go in and come out as numpy trees of ``(P, 1, ...)`` leaves.
    On CUDA the step is one fused controller-step launch and one
    readiness-table launch; their events and tables are copied to the
    host before the next launch overwrites them.  ``plans`` keeps this
    exploration's kernel plans (one per lane count)."""

    def __init__(self, cspec, ccfg, device):
        self.cspec, self.ccfg = cspec, ccfg
        self.device = device
        self.dp = D.dyn_params(cspec, device)
        self.plans: dict = {}

    def __call__(self, cs_np, want, is_write, sub, row, clk: int):
        dev, P = self.device, len(want)
        up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        cs = C._tree(up, cs_np)
        col = lambda a, *sh: up(np.asarray(a).reshape((P, 1) + sh))
        q, _ = C.queue_insert(cs.queue, col(is_write, 1), False,
                              col(sub, 1, sub.shape[-1]), col(row, 1), 0,
                              clk, col(want))
        cs = cs._replace(queue=q)
        clks = torch.full((P,), clk, dtype=torch.int32, device=dev)
        active = torch.ones((P,), dtype=torch.bool, device=dev)
        cs, ev = C.controller_step(self.cspec, self.dp, self.ccfg, cs, clks,
                                   active, plans=self.plans)
        lanes = C._tree(lambda a: a.reshape((P,) + a.shape[2:]), cs.dev)
        table = D.earliest_ready_table(self.cspec, self.dp, lanes)
        host = lambda a: a.cpu().numpy().copy()
        ev_np = {k: host(getattr(ev, k)[:, 0])
                 for k in ("cmd", "bank", "row", "arrive", "hit_ready")}
        return C._tree(host, cs), ev_np, host(table)


def _tree_index(tree, i):
    return C._tree(lambda x: x[i], tree)


def _tree_stack(trees):
    return C._tree(lambda *xs: np.stack(xs), *trees)


def _leaves(tree):
    if isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _state_key(cs) -> bytes:
    return b"".join(np.ascontiguousarray(leaf).tobytes()
                    for leaf in _leaves(cs))


# ---------------------------------------------------------------------------
# Oracle-side checks
# ---------------------------------------------------------------------------

def _dut_issue_checked(dut, cspec, cmd_id, bank, row, clk):
    """Issue one engine event on the oracle with legality checking.
    Returns an error string on disagreement, None when legal."""
    name = cspec.cmd_names[int(cmd_id)]
    addr = addr_from_bank(dut.cspec, int(bank), int(row))
    try:
        dut.issue(name, addr, clk=int(clk), check=True)
    except AssertionError as e:
        return str(e)
    return None


def _table_mismatch(dut, cspec, table) -> str | None:
    """Compare the engine's full earliest-ready table against the oracle.
    Returns a description of the first mismatch, None when identical."""
    for b in range(int(cspec.n_banks)):
        addr = addr_from_bank(dut.cspec, b, 0)
        for ci, name in enumerate(cspec.cmd_names):
            want = int(dut.earliest(name, addr))
            got = int(table[ci, b])
            if got != want:
                return (f"earliest_ready[{name}, bank={b}] "
                        f"engine={got} oracle={want}")
    return None


# ---------------------------------------------------------------------------
# Scalar path replay (minimization + counterexample export)
# ---------------------------------------------------------------------------

def _init_state(cspec, ccfg) -> tuple:
    """The reset state of one lane as a numpy tree of ``(1, ...)``
    leaves (built on the CPU: it is host data until a chunk is sent)."""
    cs = C.init_ctrl_state(cspec, ccfg.queue_depth, 1, "cpu")
    return C._tree(lambda a: a.numpy().copy(), cs)


def _run_path(cspec, oracle_cspec, ccfg, step, alphabet, path,
              check_tables=False):
    """Replay one injection path as a single lane; stop at the first
    divergence.  Returns (events, divergence|None) where events are the
    issued commands up to and including the failing one."""
    want_a, wr_a, sub_a, row_a = _encode_alphabet(cspec, alphabet)
    cs = _tree_stack([_init_state(cspec, ccfg)])
    dut = DeviceUnderTest.from_compiled(oracle_cspec)
    events = []
    for d, choice in enumerate(path):
        ch = np.asarray([choice])
        cs, ev, table = step(cs, want_a[ch], wr_a[ch], sub_a[ch], row_a[ch],
                             d)
        for slot in range(ev["cmd"].shape[1]):
            ci = int(ev["cmd"][0, slot])
            if ci < 0:
                continue
            rec = dict(clk=d, cmd=ci, bank=int(ev["bank"][0, slot]),
                       row=int(ev["row"][0, slot]), bus=slot,
                       arrive=int(ev["arrive"][0, slot]),
                       hit_ready=int(ev["hit_ready"][0, slot]))
            events.append(rec)
            err = _dut_issue_checked(dut, cspec, ci, rec["bank"],
                                     rec["row"], d)
            if err is not None:
                return events, Divergence(
                    "illegal_issue", d, cspec.cmd_names[ci], rec["bank"],
                    rec["row"], err, tuple(path))
        if check_tables:
            err = _table_mismatch(dut, cspec, table[0])
            if err is not None:
                return events, Divergence("earliest_mismatch", d, "-", -1,
                                          -1, err, tuple(path))
    return events, None


def minimize_path(path, fails) -> tuple:
    """Greedy delta-debug: replace each injection with the no-op while
    the failure persists, then truncate to the failing depth."""
    cur = list(path)
    for i in range(len(cur)):
        if cur[i] == 0:
            continue
        trial = cur[:i] + [0] + cur[i + 1:]
        if fails(trial) is not None:
            cur = trial
    div = fails(cur)
    assert div is not None, "minimization lost the failure"
    return tuple(cur[:div.depth + 1])


def _counterexample_trace(oracle_cspec, events, n_cycles, ccfg,
                          engine_cspec, path, divergence,
                          config: dict | None) -> CommandTrace:
    col = lambda k: np.asarray([e[k] for e in events], np.int32)
    meta = base_meta(
        oracle_cspec, controller=ccfg,
        counterexample={
            "path": [int(c) for c in path],
            "divergence": {"kind": divergence.kind,
                           "clk": divergence.depth,
                           "cmd": divergence.cmd,
                           "bank": divergence.bank,
                           "row": divergence.row,
                           "detail": divergence.detail},
            "engine_fingerprint": spec_fingerprint_hex(engine_cspec),
            "config": config or {},
        })
    return CommandTrace(clk=col("clk"), cmd=col("cmd"), bank=col("bank"),
                        row=col("row"), bus=col("bus"), arrive=col("arrive"),
                        hit_ready=col("hit_ready"), chan=None,
                        n_cycles=int(n_cycles),
                        cmd_names=list(oracle_cspec.cmd_names), meta=meta)


def load_counterexample(path: str):
    """Rebuild (oracle_cspec, trace) from a counterexample artifact.

    The tiny ``"TINY"`` organization is not registered, so the artifact
    embeds its reconstruction recipe in ``meta["counterexample"]
    ["config"]`` — enough for ``tiny_spec`` to recompile the oracle the
    counterexample should be audited against."""
    tr = TF.load(path)
    cfg = tr.meta.get("counterexample", {}).get("config", {})
    if not cfg:
        raise ValueError(f"{path}: no counterexample config in meta")
    cspec = tiny_spec(cfg["standard"], banks=cfg["banks"], rows=cfg["rows"],
                      columns=cfg["columns"], fast=cfg.get("fast", False),
                      nrefi=cfg.get("nrefi"),
                      timing_overrides=cfg.get("timing_overrides"))
    return cspec, tr


# ---------------------------------------------------------------------------
# Deliberate miscompilation (negative-path harness input)
# ---------------------------------------------------------------------------

def loosen_constraint(cspec, prev: str = "ACT", following: str = "RD",
                      amount: int = 1):
    """Return a copy of ``cspec`` with the (prev, following) pairwise
    constraint loosened by ``amount`` cycles, plus the row index.  The
    oracle keeps the pristine table, so exploration must catch the
    engine issuing ``following`` one cycle early.  Everything the port
    runs (``DynParams``, the readiness keys, the kernel plan) is built
    from the copy's table."""
    names = list(cspec.cmd_names)
    cand = [i for i in range(len(cspec.ct_prev))
            if names[int(cspec.ct_prev[i])] == prev
            and names[int(cspec.ct_next[i])] == following
            and int(cspec.ct_win[i]) == 1 and int(cspec.ct_lat[i]) > amount]
    if not cand:
        raise ValueError(f"no loosenable {prev}->{following} row")
    i = max(cand, key=lambda j: int(cspec.ct_lat[j]))
    lat = np.array(cspec.ct_lat, np.int64).copy()
    lat[i] -= amount
    return dataclasses.replace(cspec, ct_lat=lat), i


# ---------------------------------------------------------------------------
# The explorer
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("cs", "dut", "path")

    def __init__(self, cs, dut, path):
        self.cs, self.dut, self.path = cs, dut, path


def _copy_dut(dut: DeviceUnderTest) -> DeviceUnderTest:
    d = DeviceUnderTest.from_compiled(dut.cspec)
    d.last_issue = dut.last_issue.copy()
    d.win_ring = dut.win_ring.copy()
    d.row_state = dut.row_state.copy()
    d.act1_row = dut.act1_row.copy()
    d.act1_clk = dut.act1_clk.copy()
    d.clock_until = dut.clock_until.copy()
    d.history = list(dut.history)
    return d


def explore(cspec, *, depth: int = 10, ccfg: ControllerConfig | None = None,
            oracle=None, alphabet=None, max_frontier: int = 128,
            check_tables: bool = True, artifact_dir: str | None = None,
            chunk: int = 64, config_doc: dict | None = None,
            standard: str | None = None,
            device: str | torch.device | None = None) -> ExploreResult:
    """Breadth-first exploration of the controller step to ``depth``.

    ``oracle`` (a CompiledSpec, default ``cspec``) is what the scalar
    DUT compiles from — pass the pristine spec here and a loosened one
    as ``cspec`` to demonstrate counterexample extraction.  On the first
    divergence the injection path is minimized and exported (into
    ``artifact_dir`` when given).  ``device`` (``None`` = CUDA, which
    raises without a card) runs the transitions: the fused
    controller-step and readiness kernels on CUDA, the plain step on the
    CPU."""
    dev = _device.resolve(device)
    ccfg = ccfg or ControllerConfig(queue_depth=2)
    oracle_cspec = oracle if oracle is not None else cspec
    alphabet = tuple(alphabet) if alphabet is not None \
        else default_alphabet(cspec)
    want_a, wr_a, sub_a, row_a = _encode_alphabet(cspec, alphabet)
    A = len(alphabet)
    step = _Step(cspec, ccfg, dev)

    cs0 = _init_state(cspec, ccfg)
    frontier = [_Node(cs0, DeviceUnderTest.from_compiled(oracle_cspec), ())]

    res = ExploreResult(standard=standard or cspec.standard, depth=depth,
                        states_explored=1, edges=0, commands_checked=0,
                        tables_checked=0, truncated=False, divergences=[])

    for d in range(depth):
        edges = [(ni, a) for ni in range(len(frontier)) for a in range(A)]
        res.edges += len(edges)
        next_frontier, layer_seen = [], set()
        for lo in range(0, len(edges), chunk):
            batch = edges[lo:lo + chunk]
            pad = chunk - len(batch)
            padded = batch + [batch[0]] * pad
            cs_b = _tree_stack([frontier[ni].cs for ni, _ in padded])
            ch = np.asarray([a for _, a in padded])
            new_cs, ev, tables = step(cs_b, want_a[ch], wr_a[ch], sub_a[ch],
                                      row_a[ch], d)
            for e, (ni, a) in enumerate(batch):
                parent = frontier[ni]
                path2 = parent.path + (a,)
                dut2 = _copy_dut(parent.dut)
                bad = None
                for slot in range(ev["cmd"].shape[1]):
                    ci = int(ev["cmd"][e, slot])
                    if ci < 0:
                        continue
                    res.commands_checked += 1
                    err = _dut_issue_checked(dut2, cspec, ci,
                                             ev["bank"][e, slot],
                                             ev["row"][e, slot], d)
                    if err is not None:
                        bad = Divergence("illegal_issue", d,
                                         cspec.cmd_names[ci],
                                         int(ev["bank"][e, slot]),
                                         int(ev["row"][e, slot]), err, path2)
                        break
                if bad is None and check_tables:
                    res.tables_checked += 1
                    err = _table_mismatch(dut2, cspec, tables[e])
                    if err is not None:
                        bad = Divergence("earliest_mismatch", d, "-", -1,
                                         -1, err, path2)
                if bad is not None:
                    res.divergences.append(bad)
                    continue          # do not expand past a divergence
                if len(next_frontier) >= max_frontier:
                    res.truncated = True
                    continue
                child = _tree_index(new_cs, e)
                key = _state_key(child)
                if key in layer_seen:
                    continue
                layer_seen.add(key)
                next_frontier.append(_Node(child, dut2, path2))
            if res.divergences:
                break
        if res.divergences:
            break
        res.states_explored += len(next_frontier)
        frontier = next_frontier
        if not frontier:
            break

    if res.divergences:
        first = res.divergences[0]

        def fails(trial):
            _, div = _run_path(cspec, oracle_cspec, ccfg, step, alphabet,
                               trial, check_tables=(first.kind ==
                                                    "earliest_mismatch"))
            return div

        mpath = minimize_path(list(first.path), fails)
        events, div = _run_path(cspec, oracle_cspec, ccfg, step, alphabet,
                                mpath, check_tables=(first.kind ==
                                                     "earliest_mismatch"))
        trace = _counterexample_trace(oracle_cspec, events, len(mpath),
                                      ccfg, cspec, mpath, div, config_doc)
        artifact = None
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
            artifact = TF.save(trace, os.path.join(
                artifact_dir,
                f"counterexample_{res.standard}_d{div.depth}"))
        res.counterexample = Counterexample(mpath, div, trace, artifact)
    return res


# ---------------------------------------------------------------------------
# Smoke-tier sweep (CI entry point)
# ---------------------------------------------------------------------------

#: the small configs of the smoke tier: (name, tiny_spec kwargs,
#: controller kwargs, explore kwargs)
SMOKE_CONFIGS = (
    ("b2-q2", dict(banks=2), dict(queue_depth=2), dict(depth=10)),
    ("b2-q3-fast", dict(banks=2, fast=True), dict(queue_depth=3),
     dict(depth=14)),
    ("b4-q2", dict(banks=4), dict(queue_depth=2), dict(depth=8)),
)


def smoke(standards=("DDR4", "DDR5", "HBM3"), configs=SMOKE_CONFIGS,
          **kw) -> dict:
    """Run the bounded-exploration smoke matrix; {(standard, cfg): result}.
    ``kw`` goes to :func:`explore` (``device=`` included)."""
    results = {}
    for std in standards:
        for name, tkw, ckw, ekw in configs:
            cspec = tiny_spec(std, **tkw)
            cfg_doc = dict(standard=std, rows=int(cspec.rows),
                           columns=int(cspec.columns), **tkw)
            results[(std, name)] = explore(
                cspec, ccfg=ControllerConfig(**ckw), standard=std,
                config_doc=cfg_doc, **dict(ekw, **kw))
    return results
