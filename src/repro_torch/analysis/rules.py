"""Declarative rule registry + built-in DRAM-spec lint rules (the port's
copy of ``repro.analysis.rules``, over the port's ``CompiledSpec`` and
standards).

Rules come in two scopes:

* ``standard`` — semantic checks on the *authored* spec (a
  :class:`repro_torch.core.spec.DRAMSpec` subclass plus a chosen org/timing
  preset and optional overrides), run **before** compilation so a broken
  DSL-authored spec fails legibly instead of crashing ``compile_spec``:
  unknown timing tokens in latency expressions, dangling command / level
  references, unknown override keys, unused timing parameters.
* ``table`` — checks on the lowered :class:`CompiledSpec` constraint
  tables: derived-timing inequalities (with their JEDEC rationale),
  constraint dominance/shadowing (dead table rows), coverage holes
  (unconstrained same-bank hazard pairs), refresh schedulability, and
  windowed-ring capacity validation against ``build_windowed_rings``.

Every rule carries its rationale; ``families`` restricts a rule to
standards whose name matches one of the given prefixes (``None`` = every
standard).  Register new rules with the :func:`rule` decorator — the
linter drivers in ``repro_torch.analysis.speclint`` iterate the registry, so a
user-authored rule module only has to import and decorate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.report import ERROR, INFO, WARN, Finding
from repro_torch.core import spec as S
from repro_torch.core.compile import (_TOKEN, build_windowed_rings,
                                      resolve_latency)

#: timing parameters consumed by the engine/controller directly rather
#: than through constraint-table latency expressions — never "unused"
ENGINE_PARAMS = frozenset({"tCK_ps", "nREFI", "nAAD", "nWCKIDLE",
                           "nRCKIDLE"})

#: refresh duty cycle (nRFC / nREFI) above which scheduling headroom is
#: considered suspicious (GDDR sits near 0.15; JEDEC postpone rules
#: assume plenty of slack)
REFRESH_DUTY_WARN = 0.25


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    scope: str                     # "standard" | "table"
    severity: str                  # default severity of its findings
    rationale: str
    families: tuple | None        # standard-name prefixes (None = all)
    fn: object


RULES: dict = {}


def rule(rule_id: str, *, scope: str, severity: str = ERROR,
         rationale: str = "", families=None):
    """Register a lint rule.  The decorated function receives a
    :class:`RuleCtx` and yields findings via ``ctx.finding(...)``."""
    if scope not in ("standard", "table"):
        raise ValueError(f"rule scope must be standard|table, got {scope!r}")

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, scope, severity, rationale,
                              None if families is None else tuple(families),
                              fn)
        return fn
    return deco


def applicable(r: Rule, standard_name: str) -> bool:
    if r.families is None:
        return True
    return any(standard_name == f or standard_name.startswith(f)
               for f in r.families)


class RuleCtx:
    """Everything a rule may inspect, plus the finding factory.

    ``std`` is the DRAMSpec class (standard-scope rules; may be ``None``
    when linting a bare CompiledSpec), ``cspec`` the compiled tables
    (table-scope rules), ``timings`` the resolved preset incl. overrides.
    """

    def __init__(self, *, std=None, cspec=None, timings=None,
                 base_timings=None, overrides=None, channels: int = 1,
                 target: str = ""):
        self.std = std
        self.cspec = cspec
        self.timings = dict(timings or {})
        #: preset timings *before* overrides merged (override validation)
        self.base_timings = dict(base_timings
                                 if base_timings is not None else self.timings)
        self.overrides = dict(overrides or {})
        self.channels = int(channels)
        self.target = target or (cspec.name if cspec is not None
                                 else getattr(std, "name", "?"))
        self._rule: Rule | None = None

    def finding(self, message: str, *, severity: str | None = None,
                rows=(), data=()) -> Finding:
        r = self._rule
        return Finding(rule=r.id, severity=severity or r.severity,
                       message=message, target=self.target, rows=rows,
                       data=data)

    def row_name(self, i: int) -> str:
        cs = self.cspec
        p = cs.cmd_names[int(cs.ct_prev[i])]
        f = cs.cmd_names[int(cs.ct_next[i])]
        lv = cs.levels[int(cs.ct_level[i])]
        name = f"{p}->{f}@{lv} lat={int(cs.ct_lat[i])}"
        if int(cs.ct_win[i]) > 1:
            name += f" win={int(cs.ct_win[i])}"
        return name


def run_rules(ctx: RuleCtx, scope: str) -> list:
    """Run every applicable registered rule of ``scope``; returns
    findings (rules see the shared ctx; a rule raising is a bug, not a
    finding — let it propagate)."""
    out = []
    for r in RULES.values():
        if r.scope != scope or not applicable(r, ctx.target.split("[")[0]):
            continue
        ctx._rule = r
        out.extend(r.fn(ctx))
        ctx._rule = None
    return out


# ==========================================================================
# standard-scope rules (pre-compile semantic analysis)
# ==========================================================================

def _expr_tokens(expr) -> list:
    if isinstance(expr, int):
        return []
    return [tok for _sign, tok in _TOKEN.findall(expr) if not tok.isdigit()]


@rule("unknown-token", scope="standard", severity=ERROR,
      rationale="A latency expression referencing a timing parameter the "
                "preset does not define can never be resolved; compiling "
                "would fail. Catching it here names the constraint.")
def check_unknown_tokens(ctx):
    for k, tc in enumerate(ctx.std.timing_constraints):
        for tok in _expr_tokens(tc.latency):
            if tok not in ctx.timings:
                yield ctx.finding(
                    f"constraint #{k} {list(tc.preceding)}->"
                    f"{list(tc.following)}@{tc.level}: latency expression "
                    f"{tc.latency!r} references unknown timing parameter "
                    f"{tok!r} (known: {sorted(ctx.timings)})",
                    data={"constraint": k, "token": tok})


@rule("unused-param", scope="standard", severity=WARN,
      rationale="A preset parameter no constraint expression (and no "
                "engine consumer) reads is usually a typo'd name — the "
                "intended constraint silently keeps its old latency.")
def check_unused_params(ctx):
    used: set = set()
    for tc in ctx.std.timing_constraints:
        used.update(_expr_tokens(tc.latency))
    # read_latency (nCL + nBL) is an engine-level consumer
    used.update({"nCL", "nBL", "nCWL"})
    declared = set(ctx.timings) | set(ctx.std.timing_params)
    for name in sorted(declared - used - ENGINE_PARAMS):
        yield ctx.finding(
            f"timing parameter {name!r} is never referenced by any "
            "constraint latency expression or engine consumer",
            data={"param": name})


@rule("bad-reference", scope="standard", severity=ERROR,
      rationale="Constraints naming commands or hierarchy levels the "
                "standard does not declare lower into out-of-range table "
                "indices — the engine would check the wrong rows.")
def check_references(ctx):
    std = ctx.std
    cmds = set(std.commands)
    levels = set(std.levels)
    for name in std.commands:
        if name not in std.command_meta:
            yield ctx.finding(f"command {name!r} has no command_meta entry",
                              data={"command": name})
    for k, tc in enumerate(std.timing_constraints):
        if tc.level not in levels:
            yield ctx.finding(
                f"constraint #{k}: unknown level {tc.level!r} "
                f"(levels: {list(std.levels)})", data={"constraint": k})
        for name in list(tc.preceding) + list(tc.following):
            if name not in cmds:
                yield ctx.finding(
                    f"constraint #{k}: unknown command {name!r}",
                    data={"constraint": k, "command": name})
        if tc.window < 1:
            yield ctx.finding(
                f"constraint #{k}: window must be >= 1, got {tc.window}",
                data={"constraint": k})


@rule("unknown-override", scope="standard", severity=ERROR,
      rationale="timing_overrides keys outside the preset/param namespace "
                "silently add dead entries instead of changing the "
                "intended timing — the classic tRRD vs nRRD_S typo.")
def check_override_keys(ctx):
    valid = (set(ctx.base_timings) | set(ctx.std.timing_params)
             | {"tCK_ps"})
    for key in sorted(set(ctx.overrides) - valid):
        yield ctx.finding(
            f"timing override {key!r} matches no timing parameter of "
            f"{ctx.std.name} (valid: {sorted(valid)})",
            data={"override": key})


# ==========================================================================
# table-scope rules (compiled constraint-table analysis)
# ==========================================================================

#: derived-timing inequalities: (rule id, lhs expr, rhs expr, families,
#: JEDEC rationale).  Expressions resolve through the same
#: ``resolve_latency`` grammar the spec compiler uses; a rule is skipped
#: when the preset does not define every referenced parameter.
INEQUALITIES = (
    ("trc-decomposition", "nRC", "nRAS+nRP", None,
     "JEDEC: the row cycle tRC is the activate phase (tRAS) plus the "
     "precharge phase (tRP); tRC < tRAS + tRP lets back-to-back ACTs "
     "violate precharge time on the same bank."),
    ("faw-four-activates", "nFAW", "nRRD_S+nRRD_S+nRRD_S+nRRD_S", None,
     "JEDEC: the four-activate window spans at least four consecutive "
     "ACT-to-ACT (tRRD) intervals; tFAW < 4*tRRD makes the window "
     "constraint vacuous and overstates activation throughput."),
    ("ras-covers-rcd", "nRAS", "nRCD", None,
     "JEDEC: a row must stay active at least until its first column "
     "access can issue (tRCD); tRAS < tRCD closes rows before use."),
    ("ccd-long-short", "nCCD_L", "nCCD_S", None,
     "JEDEC: same-bank-group column spacing (tCCD_L) cannot be tighter "
     "than the cross-group spacing (tCCD_S)."),
    ("rrd-long-short", "nRRD_L", "nRRD_S", None,
     "JEDEC: same-bank-group ACT spacing (tRRD_L) cannot be tighter "
     "than the cross-group spacing (tRRD_S)."),
    ("wtr-long-short", "nWTR_L", "nWTR_S", None,
     "JEDEC: same-bank-group write-to-read turnaround (tWTR_L) cannot "
     "be tighter than the cross-group turnaround (tWTR_S)."),
    ("vrr-covers-row-cycle", "nVRR", "nRC", ("DDR4_VRR", "DDR5_VRR"),
     "A victim-row refresh internally activates and restores the row; "
     "nVRR < nRC would let the next ACT interrupt the restore."),
)


def _make_inequality_rule(rid, lhs, rhs, families, rationale):
    @rule(rid, scope="table", severity=ERROR, rationale=rationale,
          families=families)
    def check(ctx, _lhs=lhs, _rhs=rhs, _rat=rationale):
        t = ctx.timings
        toks = _expr_tokens(_lhs) + _expr_tokens(_rhs)
        if any(tok not in t for tok in toks):
            return                     # parameter family not modeled here
        lv, rv = resolve_latency(_lhs, t), resolve_latency(_rhs, t)
        if lv < rv:
            yield ctx.finding(
                f"derived-timing inequality violated: {_lhs} = {lv} < "
                f"{_rhs} = {rv}. {_rat}",
                data={"lhs": _lhs, "lhs_value": lv,
                      "rhs": _rhs, "rhs_value": rv})
    return check


for _ineq in INEQUALITIES:
    _make_inequality_rule(*_ineq)


def _reachable(cs, i: int) -> bool:
    return int(cs.ct_level[i]) <= int(cs.cmd_scope[int(cs.ct_prev[i])])


@rule("unreachable-row", scope="table", severity=WARN,
      rationale="A constraint at a hierarchy level deeper than its "
                "preceding command's scope can never bind: the command "
                "never stamps that level's issue timestamps.")
def check_unreachable(ctx):
    cs = ctx.cspec
    for i in range(len(cs.ct_prev)):
        if not _reachable(cs, i):
            yield ctx.finding(
                f"dead table row {ctx.row_name(i)}: "
                f"{cs.cmd_names[int(cs.ct_prev[i])]} has scope "
                f"{cs.levels[int(cs.cmd_scope[int(cs.ct_prev[i])])]} and "
                f"never stamps level {cs.levels[int(cs.ct_level[i])]}",
                rows=(i,))
        elif int(cs.ct_level[i]) > int(cs.cmd_scope[int(cs.ct_next[i])]):
            yield ctx.finding(
                f"suspicious row {ctx.row_name(i)}: constraint level is "
                f"deeper than the following command's scope "
                f"({cs.levels[int(cs.cmd_scope[int(cs.ct_next[i])])]}) — "
                "it binds on an arbitrary descendant node", rows=(i,))


@rule("dominated-row", scope="table", severity=ERROR,
      rationale="A (prev,next,level) row whose latency can never bind — "
                "a tighter constraint at an equal-or-wider scope always "
                "covers it — is a dead table row: either a duplicate "
                "(same scope: spec bug) or a preset where the symbolic "
                "constraint degenerates (cross-scope: informational).")
def check_dominated(ctx):
    cs = ctx.cspec
    n = len(cs.ct_prev)
    for i in range(n):
        if not _reachable(cs, i):
            continue                   # reported by unreachable-row
        li, wi, ti = int(cs.ct_level[i]), int(cs.ct_win[i]), int(cs.ct_lat[i])
        for j in range(n):
            if j == i or not _reachable(cs, j):
                continue
            if int(cs.ct_prev[j]) != int(cs.ct_prev[i]) \
                    or int(cs.ct_next[j]) != int(cs.ct_next[i]):
                continue
            lj, wj, tj = (int(cs.ct_level[j]), int(cs.ct_win[j]),
                          int(cs.ct_lat[j]))
            # j dominates i: equal-or-wider scope, equal-or-more-recent
            # window anchor, equal-or-larger latency — strictly tighter
            # somewhere, or an exact duplicate (then flag the later row)
            if lj > li or wj > wi or tj < ti:
                continue
            strict = (lj < li) or (wj < wi) or (tj > ti)
            if not strict and j >= i:
                continue
            same_scope = lj == li
            how = ("duplicate/shadowed by" if same_scope
                   else "covered by wider-scope row")
            yield ctx.finding(
                f"row {ctx.row_name(i)} can never bind: {how} "
                f"{ctx.row_name(j)}",
                severity=ERROR if same_scope else INFO,
                rows=(i, j), data={"dominated": i, "dominator": j})
            break                      # one dominator per row is enough


@rule("coverage-hole", scope="table", severity=ERROR,
      rationale="State-machine-adjacent same-bank command pairs (the "
                "enable graph: ACT enables RD/WR, PRE enables ACT, REF "
                "blocks everything, the data bus serializes column "
                "commands) must carry an ordering constraint at some "
                "covering level — otherwise the pair can issue in the "
                "same cycle: a zero-latency issue hazard no simulation "
                "would flag.")
def check_coverage(ctx):
    cs = ctx.cspec
    fx = np.asarray(cs.cmd_fx)
    kind = np.asarray(cs.cmd_kind)
    ids = range(cs.n_cmds)
    opens = [i for i in ids if fx[i] & S.FX_OPEN]
    close_row = [i for i in ids
                 if (fx[i] & (S.FX_CLOSE | S.FX_CLOSE_ALL))
                 and kind[i] == S.KIND_ROW]
    refs = [i for i in ids if kind[i] == S.KIND_REF]
    rds = [i for i in ids if fx[i] & S.FX_FINAL_RD]
    wrs = [i for i in ids if fx[i] & S.FX_FINAL_WR]
    starter = cs.id_ACT1 if cs.id_ACT1 >= 0 else cs.id_ACT
    starters = [starter] if starter >= 0 else []

    required: list = []                # (prev, next, why)
    for o in opens:
        for f in rds + wrs:
            required.append((o, f, "activate-to-column (tRCD)"))
        for c in close_row:
            required.append((o, c, "activate-to-precharge (tRAS)"))
        for st in starters:
            required.append((o, st, "row cycle (tRC)"))
    for c in close_row:
        for st in starters:
            required.append((c, st, "precharge-to-activate (tRP)"))
        for r in refs:
            required.append((c, r, "precharge-to-refresh (tRP)"))
    for r in refs:
        for st in starters:
            required.append((r, st, "refresh recovery (tRFC)"))
        required.append((r, r, "refresh-to-refresh (tRFC)"))
        for f in rds + wrs:
            required.append((r, f, "refresh recovery (tRFC)"))
    for a in rds + wrs:
        for b in rds + wrs:
            required.append((a, b, "data-bus serialization (nBL/tCCD)"))
    for a in rds:
        for c in close_row:
            required.append((a, c, "read-to-precharge (tRTP)"))
    for a in wrs:
        for c in close_row:
            required.append((a, c, "write recovery (tWR)"))
    for st in starters:
        required.append((st, st, "activate-to-activate (tRRD)"))

    covered = set()
    for i in range(len(cs.ct_prev)):
        if _reachable(cs, i) and int(cs.ct_lat[i]) >= 1:
            covered.add((int(cs.ct_prev[i]), int(cs.ct_next[i])))
    seen = set()
    for p, f, why in required:
        if (p, f) in covered or (p, f) in seen:
            continue
        seen.add((p, f))
        yield ctx.finding(
            f"coverage hole: no ordering constraint for same-bank pair "
            f"{cs.cmd_names[p]}->{cs.cmd_names[f]} at any level — "
            f"expected {why}; the pair can issue zero cycles apart",
            data={"prev": cs.cmd_names[p], "next": cs.cmd_names[f],
                  "expected": why})


@rule("refresh-headroom", scope="table", severity=ERROR,
      rationale="Refresh is schedulable only when the recovery time "
                "(tRFC) fits inside the refresh interval (tREFI) with "
                "headroom for pending work; per-channel stagger shifts "
                "each channel's epoch by tREFI/C, so overlapping "
                "recovery windows defeat the stagger's purpose.")
def check_refresh(ctx):
    t = ctx.timings
    if "nRFC" not in t or "nREFI" not in t:
        return
    nrfc, nrefi = int(t["nRFC"]), int(t["nREFI"])
    if nrefi <= 0 or nrfc <= 0:
        yield ctx.finding(f"non-positive refresh timing: nRFC={nrfc}, "
                          f"nREFI={nrefi}")
        return
    if nrfc >= nrefi:
        yield ctx.finding(
            f"refresh unschedulable: nRFC={nrfc} >= nREFI={nrefi} — the "
            "device spends its whole interval (or more) in recovery and "
            "the controller can never drain demand traffic")
        return
    duty = nrfc / nrefi
    if duty > REFRESH_DUTY_WARN:
        yield ctx.finding(
            f"refresh duty cycle {duty:.1%} (nRFC={nrfc} / nREFI={nrefi}) "
            f"exceeds {REFRESH_DUTY_WARN:.0%} — little headroom for "
            "demand traffic between refreshes", severity=WARN,
            data={"duty": round(duty, 4)})
    if ctx.channels > 1:
        spacing = nrefi // ctx.channels
        if spacing < nrfc:
            yield ctx.finding(
                f"per-channel refresh stagger overlap: stagger spacing "
                f"nREFI/C = {spacing} < nRFC = {nrfc} with C = "
                f"{ctx.channels} channels — staggered refresh recovery "
                "windows overlap, so system bandwidth still dips",
                severity=WARN,
                data={"channels": ctx.channels, "spacing": spacing})


@rule("ring-capacity", scope="table", severity=ERROR,
      rationale="The engine reads window>1 constraints from compact "
                "per-(command, level) rings planned at compile time; a "
                "ring layout inconsistent with the constraint table "
                "silently reads the wrong issue history.")
def check_rings(ctx):
    cs = ctx.cspec
    want = build_windowed_rings(
        np.asarray(cs.ct_prev), np.asarray(cs.ct_level),
        np.asarray(cs.ct_win), np.asarray(cs.cmd_scope),
        np.asarray(cs.level_counts), np.asarray(cs.level_offsets))
    pairs = dict(
        ring_pairs=[tuple(p) for p in cs.ring_pairs],
        n_ring=int(cs.n_ring), ring_depth=int(cs.ring_depth))
    want_pairs = dict(
        ring_pairs=[tuple(p) for p in want["ring_pairs"]],
        n_ring=int(want["n_ring"]), ring_depth=int(want["ring_depth"]))
    for field in ("ring_pairs", "n_ring", "ring_depth"):
        if pairs[field] != want_pairs[field]:
            yield ctx.finding(
                f"windowed-ring layout mismatch: {field} is "
                f"{pairs[field]!r} but the constraint table needs "
                f"{want_pairs[field]!r} — rebuild via "
                "build_windowed_rings", data={"field": field})
            return
    for field in ("ring_cmd", "ring_level", "ring_node", "ct_ring"):
        have = np.asarray(getattr(cs, field))
        if have.shape != want[field].shape \
                or not np.array_equal(have, want[field]):
            yield ctx.finding(
                f"windowed-ring table mismatch: {field} disagrees with "
                "build_windowed_rings for this constraint table",
                data={"field": field})
            return
    # capacity: the allocated depth must cover the deepest reachable window
    deep = [int(cs.ct_win[i]) for i in range(len(cs.ct_prev))
            if int(cs.ct_win[i]) > 1 and _reachable(cs, i)]
    if deep and int(cs.ring_depth) < max(deep):
        yield ctx.finding(
            f"ring depth {int(cs.ring_depth)} cannot hold the deepest "
            f"window ({max(deep)}) — windowed constraints would read "
            "evicted history", data={"depth": int(cs.ring_depth),
                                     "max_window": max(deep)})
