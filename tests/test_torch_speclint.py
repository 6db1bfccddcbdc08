"""PyTorch port, the spec linter against the JAX package's: for every
registered standard at its first-authored presets, for a 4-channel
DDR5, the hetero composition and the bad-override corners of
``tests/analysis/test_speclint.py`` and ``test_dse_lint.py`` (a ``tRC``
below ``tRAS + tRP``, a VRR below the row cycle, a squeezed refresh
interval, an unschedulable refresh, a typo'd override key, a corrupted
ring table, an unused parameter), the port's ``LintReport`` holds the
reference's findings exactly (rule, severity, message, target, rows,
data) and its summary text; reports cross between the packages as JSON;
the sweep's pre-lint gate and the compile-time gate
(``compile_spec(lint=...)``, ``REPRO_SPEC_LINT``) behave as the
reference's.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.analysis as JA                                 # noqa: E402
import repro.core.compile as JC                             # noqa: E402
import repro.core.spec as JS                                # noqa: E402
import repro.core.standards  # noqa: E402,F401
from repro.dse.executor import lint_sweep_systems as j_gate  # noqa: E402
from repro.dse.spec import Composition as JComp             # noqa: E402
from repro.dse.spec import SweepSpec as JSweep              # noqa: E402

import repro_torch.analysis as TA                           # noqa: E402
import repro_torch.core.compile as TC                       # noqa: E402
import repro_torch.core.spec as TS                          # noqa: E402
from repro_torch.dse.executor import lint_sweep_systems as t_gate  # noqa
from repro_torch.dse.spec import Composition as TComp       # noqa: E402
from repro_torch.dse.spec import SweepSpec as TSweep        # noqa: E402

from torch_parity import HETERO_SYSTEM                      # noqa: E402

STANDARDS = sorted(JS.all_standards())
BAD_DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", {"nRC": 1})


def same(j, t):
    """Two reports hold the same findings, metadata and text."""
    assert t.target == j.target
    assert [f.to_dict() for f in t.findings] == \
        [f.to_dict() for f in j.findings]
    assert t.meta == j.meta
    assert t.summary(show_info=True) == j.summary(show_info=True)
    assert t.counts() == j.counts() and t.ok() == j.ok()
    return t


def test_registry_equals_reference():
    assert list(TA.RULES) == list(JA.RULES)
    for rid, r in TA.RULES.items():
        jr = JA.RULES[rid]
        assert (r.scope, r.severity, r.rationale, r.families) == \
            (jr.scope, jr.severity, jr.rationale, jr.families)


@pytest.mark.parametrize("std", STANDARDS)
def test_standard_lints_as_reference(std):
    assert TA.default_presets(std) == JA.default_presets(std)
    rep = same(JA.lint_spec(std), TA.lint_spec(std))
    assert rep.ok(strict=True) and rep.meta["compiled"] is True


def test_lint_all_system_and_channels_equal_reference():
    j, t = JA.lint_all(), TA.lint_all()
    assert sorted(t) == sorted(j) == STANDARDS
    for name in STANDARDS:
        same(j[name], t[name])
    same(JA.lint_spec("DDR5", channels=4), TA.lint_spec("DDR5", channels=4))
    rep = same(JA.lint_system(JC.compile_system(HETERO_SYSTEM)),
               TA.lint_system(TC.compile_system(HETERO_SYSTEM)))
    assert len(rep.meta["groups"]) == 2


#: (standard, overrides, channels) corners and the rule each must fire
CORNERS = {
    "trc": ("DDR4", {"nRC": 1}, 1, "trc-decomposition"),
    "trc_ddr5": ("DDR5", {"nRC": 10}, 1, "trc-decomposition"),
    "faw": ("DDR4", {"nFAW": 1}, 1, "faw-four-activates"),
    "vrr": ("DDR5_VRR", {"nVRR": 1}, 1, "vrr-covers-row-cycle"),
    "refresh_squeeze": ("DDR4", {"nREFI": 3 * 420}, 4, "refresh-headroom"),
    "refresh_unschedulable": ("DDR4", {"nRFC": 100_000}, 1,
                              "refresh-headroom"),
    "typo": ("DDR4", {"tRRD": 4}, 1, "unknown-override"),
}


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_bad_override_corner_equals_reference(name):
    std, ov, ch, rid = CORNERS[name]
    if name == "refresh_squeeze":
        ov = {"nREFI": 3 * JS.get_standard(std).timing_presets[
            JA.default_presets(std)[1]]["nRFC"]}
    rep = same(JA.lint_spec(std, timing_overrides=ov, channels=ch),
               TA.lint_spec(std, timing_overrides=ov, channels=ch))
    assert rid in rep.rules_fired()


def test_ring_corruption_and_unused_param_equal_reference():
    jc = JC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    tc = TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    rep = same(JA.lint_compiled(dataclasses.replace(
        jc, ring_depth=jc.ring_depth - 1)), TA.lint_compiled(
        dataclasses.replace(tc, ring_depth=tc.ring_depth - 1)))
    assert [f.rule for f in rep.errors] == ["ring-capacity"]
    same(JA.lint_compiled(jc), TA.lint_compiled(tc))
    mut = lambda S: type("DDR4_unused", (S.get_standard("DDR4"),), {
        "timing_params": tuple(S.get_standard("DDR4").timing_params)
        + ("nNEVER",)})
    rep = same(JA.lint_spec(mut(JS)), TA.lint_spec(mut(TS)))
    assert [f.rule for f in rep.warnings] == ["unused-param"]


def test_reports_cross_packages_as_json():
    j = JA.lint_spec("DDR4", timing_overrides={"nRC": 1, "tRRD": 4})
    t = TA.lint_spec("DDR4", timing_overrides={"nRC": 1, "tRRD": 4})
    assert t.to_json() == j.to_json()
    back = TA.LintReport.from_json(j.to_json())
    assert [f.key for f in back.findings] == [f.key for f in j.sorted()]
    assert JA.LintReport.from_json(t.to_json()).counts() == t.counts()
    clean_j, clean_t = JA.lint_spec("DDR4"), TA.lint_spec("DDR4")
    assert TA.render_diff(clean_t, t) == JA.render_diff(clean_j, j)
    merged = TA.merge([clean_t, t], target="both")
    assert merged.counts() == JA.merge([clean_j, j], target="both").counts()


@pytest.mark.parametrize("case", ["plain", "composition", "clean"])
def test_sweep_pre_lint_gate_equals_reference(case):
    systems = {"plain": lambda M: ("DDR5", BAD_DDR4),
               "composition": lambda M: (M(((BAD_DDR4, 2), ("DDR5", 2))),),
               "clean": lambda M: ("DDR4", ("DDR4", "DDR4_8Gb_x8",
                                            "DDR4_2400R", {"nCL": 20}))}
    jpts = JSweep(systems=systems[case](JComp), intervals=(8.0,),
                  n_cycles=400).expand()
    tpts = TSweep(systems=systems[case](TComp), intervals=(8.0,),
                  n_cycles=400).expand()
    if case == "clean":
        j_gate(jpts)
        t_gate(tpts)
        return
    with pytest.raises(JA.SpecLintError) as je:
        j_gate(jpts)
    with pytest.raises(TA.SpecLintError) as te:
        t_gate(tpts)
    rep = same(je.value.report, te.value.report)
    assert rep.target == "sweep-pre-lint"
    assert "trc-decomposition" in rep.rules_fired()
    assert str(te.value) == str(je.value)


def test_compile_gate_equals_reference(monkeypatch, capsys):
    args = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", {"nRC": 1})
    for pkg in (JC, TC):
        pkg.compile_spec(*args, lint="warn")
    out = capsys.readouterr().out
    j_out, t_out = out[:len(out) // 2], out[len(out) // 2:]
    assert t_out == j_out and "trc-decomposition" in t_out
    msgs = []
    for pkg in (JC, TC):
        with pytest.raises(ValueError) as e:
            pkg.compile_spec(*args, lint="error")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    monkeypatch.setenv("REPRO_SPEC_LINT", "error")
    with pytest.raises(ValueError, match="spec lint failed"):
        TC.compile_spec(*args)
    assert TC.compile_spec(*args[:3]).timings == \
        JC.compile_spec(*args[:3]).timings
    monkeypatch.setenv("REPRO_SPEC_LINT", "warn")
    TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    assert capsys.readouterr().out == ""       # a clean spec prints nothing
