"""Spec-linter drivers: run the rule registry over standards and systems
(the port's copy of ``repro.analysis.speclint``).

Three entry points, layered:

* :func:`lint_spec` — the full pass for one (standard, org preset, timing
  preset, overrides, channels): standard-scope rules first (unknown
  tokens, dangling references, unknown override keys), then — only when
  those produce no errors, so a broken spec fails legibly instead of
  crashing the compiler — lowers via ``compile_spec`` and runs the
  table-scope rules (inequalities, dominance, coverage holes, refresh
  headroom, ring validation).
* :func:`lint_compiled` — table-scope rules only, for an
  already-compiled :class:`CompiledSpec` (e.g. a mutated table from the
  verification harness, or a spec loaded from a checkpoint).
* :func:`lint_system` — every group of a heterogeneous
  :class:`MemorySystemSpec`, merged into one report.

``lint_all`` sweeps every registered standard with its first-authored
presets — the CI smoke gate.
"""
from __future__ import annotations

from repro_torch.analysis.report import ERROR, Finding, LintReport, merge
from repro_torch.analysis.rules import RuleCtx, run_rules
from repro_torch.core import spec as S
from repro_torch.core.compile import (MemorySystemSpec, as_system,
                                      compile_spec)


class SpecLintError(ValueError):
    """Raised when a lint gate fails; carries the structured report."""

    def __init__(self, report: LintReport):
        self.report = report
        super().__init__("spec lint failed:\n" + report.summary())


def default_presets(standard) -> tuple:
    """First-authored (org, timing) preset pair of a standard — dict
    insertion order is authoring order, so this is the spec's primary
    configuration."""
    if isinstance(standard, str):
        standard = S.get_standard(standard)
    try:
        org = next(iter(standard.org_presets))
        tim = next(iter(standard.timing_presets))
    except StopIteration:
        raise ValueError(f"standard {standard.name} declares no presets")
    return org, tim


def lint_spec(standard, org_preset: str | None = None,
              timing_preset: str | None = None,
              timing_overrides: dict | None = None,
              channels: int = 1) -> LintReport:
    """Full two-stage lint of one spec configuration."""
    if isinstance(standard, str):
        standard = S.get_standard(standard)
    if org_preset is None or timing_preset is None:
        d_org, d_tim = default_presets(standard)
        org_preset = org_preset or d_org
        timing_preset = timing_preset or d_tim
    target = f"{standard.name}[{org_preset}/{timing_preset}]"
    report = LintReport(target=target, meta={
        "standard": standard.name, "org_preset": org_preset,
        "timing_preset": timing_preset, "channels": int(channels),
        "timing_overrides": dict(timing_overrides or {})})

    base = dict(standard.timing_presets[timing_preset])
    timings = dict(base)
    if timing_overrides:
        timings.update(timing_overrides)
    ctx = RuleCtx(std=standard, timings=timings, base_timings=base,
                  overrides=timing_overrides, channels=channels,
                  target=target)
    report.extend(run_rules(ctx, "standard"))
    if not report.ok():
        # the spec cannot (or should not) be lowered — stop legibly
        report.meta["compiled"] = False
        return report

    try:
        cspec = compile_spec(standard, org_preset, timing_preset,
                             timing_overrides, channels=max(1, channels))
    except Exception as e:                      # pragma: no cover - guard
        report.add(Finding(rule="compile-error", severity=ERROR,
                           message=f"compile_spec failed: {e}",
                           target=target))
        report.meta["compiled"] = False
        return report
    report.meta["compiled"] = True
    report.extend(_table_findings(cspec, channels=channels, target=target,
                                  std=standard))
    return report


def _table_findings(cspec, channels: int, target: str, std=None) -> list:
    ctx = RuleCtx(std=std, cspec=cspec, timings=cspec.timings,
                  channels=channels, target=target)
    return run_rules(ctx, "table")


def lint_compiled(cspec, channels: int | None = None,
                  target: str | None = None) -> LintReport:
    """Table-scope lint of an already-compiled spec (post-compile gate)."""
    channels = cspec.n_channels if channels is None else channels
    target = target or (f"{cspec.standard or cspec.name}"
                        f"[{cspec.org_preset}/{cspec.timing_preset}]")
    report = LintReport(target=target, meta={
        "standard": cspec.standard or cspec.name,
        "channels": int(channels), "compiled": True})
    report.extend(_table_findings(cspec, channels=channels, target=target))
    return report


def lint_system(msys) -> LintReport:
    """Lint every group of a (possibly heterogeneous) memory system."""
    msys = as_system(msys)
    assert isinstance(msys, MemorySystemSpec)
    parts = []
    for gi, g in enumerate(msys.groups):
        cs = g.cspec
        target = f"{cs.standard or cs.name}[group{gi} x{g.channels}]"
        parts.append(lint_compiled(cs, channels=g.channels, target=target))
    out = merge(parts, target=msys.label)
    out.meta["groups"] = [p.target for p in parts]
    return out


def lint_all(channels: int = 1) -> dict:
    """Lint every registered standard (first-authored presets).

    Returns ``{standard name: LintReport}`` — the CI smoke sweep."""
    out = {}
    for name in sorted(S.all_standards()):
        out[name] = lint_spec(name, channels=channels)
    return out
