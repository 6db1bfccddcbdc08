"""Structured lint findings and report artifacts of
``repro_torch.analysis`` (the port's copy of ``repro.analysis.report``).

The spec linter emits a :class:`Finding` per defect and a
:class:`LintReport` per lint target.  Reports serialize to JSON (full
fidelity, the reference's ``repro.analysis/v1`` format) and ``.npz``
(columnar, for artifact diffing next to trace and telemetry artifacts),
and two reports diff structurally (cross-standard, or pristine against
overridden).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

ERROR = "error"
WARN = "warn"
INFO = "info"

#: severity rank for sorting / gating (highest first)
_SEV_RANK = {ERROR: 0, WARN: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint defect.

    ``rows`` are offending constraint-table row indices; ``path``/``line``
    locate source findings (the reference's source linter).  ``key``
    is the stable identity used by report diffing — it deliberately
    excludes the message text so rewording a rule does not churn diffs.
    """
    rule: str                      # registry id, e.g. "trc-decomposition"
    severity: str                  # error | warn | info
    message: str
    target: str = ""               # standard / module the finding is about
    rows: tuple = ()               # offending constraint-table rows
    path: str = ""                 # source file (source lint)
    line: int = 0                  # 1-indexed source line (0 = n/a)
    data: tuple = ()               # sorted (key, value) detail pairs

    def __post_init__(self):
        if self.severity not in _SEV_RANK:
            raise ValueError(f"unknown severity {self.severity!r}")
        object.__setattr__(self, "rows", tuple(int(r) for r in self.rows))
        d = self.data
        d = d.items() if isinstance(d, dict) else (d or ())
        object.__setattr__(self, "data",
                           tuple(sorted((str(k), v) for k, v in d)))

    @property
    def key(self) -> tuple:
        return (self.rule, self.target, self.rows, self.path, self.line)

    @property
    def location(self) -> str:
        if self.path:
            return f"{self.path}:{self.line}" if self.line else self.path
        return self.target

    def render(self) -> str:
        loc = self.location
        head = f"{self.severity.upper():5s} [{self.rule}]"
        return f"{head} {loc}: {self.message}" if loc \
            else f"{head} {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rows"] = list(self.rows)
        d["data"] = {k: v for k, v in self.data}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(rule=d["rule"], severity=d["severity"],
                   message=d["message"], target=d.get("target", ""),
                   rows=tuple(d.get("rows", ())), path=d.get("path", ""),
                   line=int(d.get("line", 0)),
                   data=tuple(sorted(d.get("data", {}).items())))


@dataclasses.dataclass
class LintReport:
    """Ordered findings for one lint target (a spec, a system, a tree)."""
    target: str
    findings: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def add(self, finding: Finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def sorted(self) -> list:
        return sorted(self.findings,
                      key=lambda f: (_SEV_RANK[f.severity], f.rule,
                                     f.location, f.rows))

    def by_severity(self, severity: str) -> list:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list:
        return self.by_severity(ERROR)

    @property
    def warnings(self) -> list:
        return self.by_severity(WARN)

    @property
    def infos(self) -> list:
        return self.by_severity(INFO)

    def ok(self, strict: bool = False) -> bool:
        """Gate predicate: no errors (``strict`` also forbids warnings)."""
        if self.errors:
            return False
        return not (strict and self.warnings)

    def counts(self) -> dict:
        return {s: len(self.by_severity(s)) for s in (ERROR, WARN, INFO)}

    def rules_fired(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def summary(self, show_info: bool = False) -> str:
        c = self.counts()
        lines = [f"{self.target}: {c[ERROR]} error(s), {c[WARN]} "
                 f"warning(s), {c[INFO]} info"]
        for f in self.sorted():
            if f.severity == INFO and not show_info:
                continue
            lines.append("  " + f.render())
        return "\n".join(lines)

    # -- artifacts ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "format": "repro.analysis/v1", "target": self.target,
            "meta": self.meta, "counts": self.counts(),
            "findings": [f.to_dict() for f in self.sorted()],
        }, indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "LintReport":
        d = json.loads(text)
        if d.get("format") != "repro.analysis/v1":
            raise ValueError(f"not a repro.analysis report: "
                             f"format={d.get('format')!r}")
        return cls(target=d["target"], meta=d.get("meta", {}),
                   findings=[Finding.from_dict(f) for f in d["findings"]])

    def save_json(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")
        return path

    @classmethod
    def load_json(cls, path: str) -> "LintReport":
        with open(path) as fh:
            return cls.from_json(fh.read())

    def save_npz(self, path: str) -> str:
        """Columnar artifact: one row per finding + JSON sidecar blob."""
        fs = self.sorted()
        np.savez_compressed(
            path,
            rule=np.asarray([f.rule for f in fs], dtype=object),
            severity=np.asarray([f.severity for f in fs], dtype=object),
            target=np.asarray([f.target for f in fs], dtype=object),
            path=np.asarray([f.path for f in fs], dtype=object),
            line=np.asarray([f.line for f in fs], np.int64),
            rows=np.asarray([json.dumps(list(f.rows)) for f in fs],
                            dtype=object),
            json=np.asarray(self.to_json()))
        return path

    @classmethod
    def load_npz(cls, path: str) -> "LintReport":
        with np.load(path, allow_pickle=True) as z:
            return cls.from_json(str(z["json"]))


def merge(reports, target: str = "all") -> LintReport:
    """Fold per-target reports into one (finding targets stay qualified)."""
    out = LintReport(target=target)
    for r in reports:
        out.extend(r.findings)
        if r.meta:
            out.meta[r.target] = r.meta
    return out


def diff(a: LintReport, b: LintReport) -> dict:
    """Structural report diff keyed on :attr:`Finding.key`.

    Returns ``{"added": [...], "removed": [...], "common": int}`` where
    added/removed are findings present only in ``b`` / only in ``a`` —
    the cross-standard (or pristine-vs-overridden) comparison mode.
    """
    ka = {f.key: f for f in a.findings}
    kb = {f.key: f for f in b.findings}
    return {
        "added": [kb[k] for k in sorted(kb.keys() - ka.keys())],
        "removed": [ka[k] for k in sorted(ka.keys() - kb.keys())],
        "common": len(ka.keys() & kb.keys()),
    }


def render_diff(a: LintReport, b: LintReport) -> str:
    d = diff(a, b)
    lines = [f"lint diff {a.target} -> {b.target}: "
             f"+{len(d['added'])} -{len(d['removed'])} "
             f"(={d['common']} unchanged)"]
    lines += ["  + " + f.render() for f in d["added"]]
    lines += ["  - " + f.render() for f in d["removed"]]
    return "\n".join(lines)
