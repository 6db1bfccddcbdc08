"""``repro_torch.analysis`` — the spec linter and the host-sync linter of
the port (the reference's ``repro.analysis``; its JAX trace-safety lint
becomes a lint of the port's cycle loop for hidden device-to-host syncs,
:mod:`~repro_torch.analysis.tracecheck`).

Semantic analysis of DRAM standards and compiled constraint tables:
derived-timing inequalities with their JEDEC rationale,
dominance/shadowing (dead rows), coverage holes (zero-latency issue
hazards), refresh schedulability, windowed-ring validation,
unknown/unused timing tokens (:mod:`~repro_torch.analysis.speclint`,
:mod:`~repro_torch.analysis.rules`).  Findings come as
:class:`~repro_torch.analysis.report.LintReport` artifacts (JSON/npz).
``compile_spec(lint="warn"|"error")`` and ``REPRO_SPEC_LINT`` run it at
compile time; the DSE executor runs it over every override-carrying
system of a sweep before running anything.
"""
from repro_torch.analysis.report import (ERROR, INFO, WARN, Finding,
                                         LintReport, diff, merge,
                                         render_diff)
from repro_torch.analysis.rules import RULES, Rule, RuleCtx, rule
from repro_torch.analysis.speclint import (SpecLintError, default_presets,
                                           lint_all, lint_compiled,
                                           lint_spec, lint_system)
from repro_torch.analysis.tracecheck import lint_package, lint_paths

__all__ = [
    "ERROR", "WARN", "INFO", "Finding", "LintReport", "diff", "merge",
    "render_diff", "RULES", "Rule", "RuleCtx", "rule", "default_presets",
    "SpecLintError", "lint_all", "lint_compiled", "lint_spec",
    "lint_system", "lint_package", "lint_paths",
]
