"""Mutation-seeded negative fixtures for the spec linter.

``repro_torch.analysis.speclint`` (the port's spec linter) gates every
authored standard; this module
asks the converse question — *does the linter actually catch broken
specs?* — the spec-level sibling of :mod:`repro_torch.verify.mutation` (which
seeds the trace auditor).  Each mutator derives a single-defect variant
of a clean registered standard, one per statically-detectable rule
class:

* ``trc-shrink``       — override ``nRC`` to ``nRAS + nRP - 1``
                         (derived-timing inequality),
* ``dominated-inject`` — append a same-scope constraint row strictly
                         looser than an existing one (dead table row),
* ``coverage-delete``  — delete the bank ``PRE -> opener`` constraint
                         (zero-latency precharge-to-activate hazard),
* ``refresh-shrink``   — override ``nREFI`` below ``nRFC``
                         (unschedulable refresh),
* ``unknown-token``    — append a constraint referencing an undeclared
                         timing parameter,
* ``override-typo``    — pass a ``timing_overrides`` key outside the
                         standard's parameter namespace,
* ``ring-corrupt``     — shrink the compiled windowed-ring depth below
                         the deepest reachable window.

Every mutator is engineered so its target rule fires **exactly once**;
:func:`spec_mutation_matrix` asserts detection across standards the
same way ``mutation_matrix`` does for the auditor.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.report import ERROR, LintReport
from repro_torch.analysis.speclint import (default_presets, lint_compiled,
                                           lint_spec)
from repro_torch.core import spec as S
from repro_torch.core.compile import compile_spec, resolve_latency


@dataclasses.dataclass
class SpecInjection:
    """One seeded spec defect and the lint rule expected to catch it."""
    mutator: str
    rule: str                  # lint rule id expected to fire
    standard: str
    detail: str
    report: LintReport

    def hits(self) -> list:
        """Error-severity findings of the expected rule."""
        return [f for f in self.report.findings
                if f.rule == self.rule and f.severity == ERROR]


def detected(inj: SpecInjection) -> bool:
    """True iff the expected rule fired exactly once, at error severity."""
    return len(inj.hits()) == 1


def _variant(std, **attrs):
    """An unregistered single-defect subclass of a standard (same name:
    the mutation models a bad edit to that standard, and family-gated
    rules must keep applying)."""
    return type(f"{std.name}_mutant", (std,), attrs)


def _base_timings(std) -> dict:
    _, tim = default_presets(std)
    return dict(std.timing_presets[tim])


# ---------------------------------------------------------------------------
# Mutators — each returns a SpecInjection, or None when the standard
# lacks the ingredients (e.g. no windowed constraint to corrupt).
# ---------------------------------------------------------------------------

def mutate_trc_shrink(std) -> SpecInjection | None:
    t = _base_timings(std)
    if not all(k in t for k in ("nRC", "nRAS", "nRP")):
        return None
    bad = int(t["nRAS"]) + int(t["nRP"]) - 1
    rep = lint_spec(std, timing_overrides={"nRC": bad})
    return SpecInjection("trc-shrink", "trc-decomposition", std.name,
                         f"nRC={bad} < nRAS+nRP={bad + 1}", rep)


def mutate_dominated_inject(std) -> SpecInjection | None:
    t = _base_timings(std)
    for tc in std.timing_constraints:
        if tc.window != 1 or len(tc.preceding) != 1 \
                or len(tc.following) != 1:
            continue
        lat = resolve_latency(tc.latency, t)
        if lat < 2:
            continue
        loose = S.TimingConstraint(
            level=tc.level, preceding=tc.preceding, following=tc.following,
            latency=lat - 1, window=1, note="mutant: shadowed duplicate")
        mut = _variant(std, timing_constraints=(
            tuple(std.timing_constraints) + (loose,)))
        rep = lint_spec(mut)
        return SpecInjection(
            "dominated-inject", "dominated-row", std.name,
            f"{list(tc.preceding)}->{list(tc.following)}@{tc.level} "
            f"lat={lat - 1} shadowed by lat={tc.latency!r}", rep)
    return None


def mutate_coverage_delete(std) -> SpecInjection | None:
    kept, dropped = [], None
    for tc in std.timing_constraints:
        if dropped is None and tc.level == "bank" \
                and list(tc.preceding) == ["PRE"]:
            dropped = tc
            continue
        kept.append(tc)
    if dropped is None:
        return None
    mut = _variant(std, timing_constraints=tuple(kept))
    rep = lint_spec(mut)
    return SpecInjection(
        "coverage-delete", "coverage-hole", std.name,
        f"deleted bank PRE->{list(dropped.following)} "
        f"({dropped.latency!r})", rep)


def mutate_refresh_shrink(std) -> SpecInjection | None:
    t = _base_timings(std)
    if not all(k in t for k in ("nRFC", "nREFI")):
        return None
    bad = int(t["nRFC"])            # nRFC >= nREFI: unschedulable
    rep = lint_spec(std, timing_overrides={"nREFI": bad})
    return SpecInjection("refresh-shrink", "refresh-headroom", std.name,
                         f"nREFI={bad} <= nRFC={t['nRFC']}", rep)


def mutate_unknown_token(std) -> SpecInjection | None:
    bogus = S.TimingConstraint(
        level="bank", preceding=["PRE"], following=["PRE"],
        latency="nBOGUS", note="mutant: undeclared parameter")
    mut = _variant(std, timing_constraints=(
        tuple(std.timing_constraints) + (bogus,)))
    rep = lint_spec(mut)
    return SpecInjection("unknown-token", "unknown-token", std.name,
                         "constraint references undeclared 'nBOGUS'", rep)


def mutate_override_typo(std) -> SpecInjection | None:
    rep = lint_spec(std, timing_overrides={"tRRD": 4})
    return SpecInjection("override-typo", "unknown-override", std.name,
                         "override key 'tRRD' (not a timing parameter)",
                         rep)


def mutate_ring_corrupt(std) -> SpecInjection | None:
    org, tim = default_presets(std)
    cspec = compile_spec(std, org, tim)
    if cspec.n_ring == 0 or cspec.ring_depth <= 1:
        return None
    bad = dataclasses.replace(cspec, ring_depth=cspec.ring_depth - 1)
    rep = lint_compiled(bad, target=f"{std.name}[ring-corrupt]")
    return SpecInjection(
        "ring-corrupt", "ring-capacity", std.name,
        f"ring_depth {cspec.ring_depth} -> {bad.ring_depth} below the "
        "deepest reachable window", rep)


MUTATORS = {
    "trc-shrink": mutate_trc_shrink,
    "dominated-inject": mutate_dominated_inject,
    "coverage-delete": mutate_coverage_delete,
    "refresh-shrink": mutate_refresh_shrink,
    "unknown-token": mutate_unknown_token,
    "override-typo": mutate_override_typo,
    "ring-corrupt": mutate_ring_corrupt,
}


def inject(standard, mutator: str) -> SpecInjection | None:
    """Run one named mutator against a standard (name or class)."""
    if isinstance(standard, str):
        standard = S.get_standard(standard)
    return MUTATORS[mutator](standard)


def spec_mutation_matrix(standards, mutators=None) -> dict:
    """{(standard, mutator): "detected" | "MISSED:..." | "skipped:..."}.

    Detection requires the expected rule to fire exactly once at error
    severity — the 100%-detection requirement, spec edition."""
    out = {}
    for name in standards:
        for mname in (mutators or MUTATORS):
            inj = inject(name, mname)
            if inj is None:
                out[(name, mname)] = "skipped: ingredient missing"
            elif detected(inj):
                out[(name, mname)] = "detected"
            else:
                n = len(inj.hits())
                out[(name, mname)] = (f"MISSED: rule {inj.rule} fired "
                                      f"{n}x ({inj.detail})")
    return out
