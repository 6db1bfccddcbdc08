"""``repro_torch.analysis`` — the spec linter of the port (the reference's
``repro.analysis`` less its JAX source linter).

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

__all__ = [
    "ERROR", "WARN", "INFO", "Finding", "LintReport", "diff", "merge",
    "render_diff", "RULES", "Rule", "RuleCtx", "rule", "default_presets",
    "SpecLintError", "lint_all", "lint_compiled", "lint_spec",
    "lint_system",
]
