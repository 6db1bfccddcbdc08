"""PyTorch port, the fixture of the validation workflow and of
``chip_smoke.py`` phase 17: ``tests/torch_verify_stats.json`` holds the
reference's side (``repro.verify``, ``repro.trace.audit``, the
visualizers and the CLIs) of every comparison the ``test_torch_verify_*``
and ``test_torch_audit_*`` files make.

* Its recipes are the constants of ``tests/torch_parity.py`` that both
  the tests and ``chip_smoke.py`` run.
* Its cheap parts are current: the reference, run again here, gives the
  same DDR4 ``b4-q2`` smoke result, the same counterexamples, the same
  spec-mutation row for DDR4 and the same differential reports.
The fixture is rewritten by ``tests/torch_parity.py --write-sim-fixtures``.
"""
import importlib
import importlib.util
import json
import os

import pytest

pytest.importorskip("torch")

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))


def _chip_smoke():
    path = os.path.join(os.path.dirname(tp.HERE), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_recipes_are_the_shared_constants():
    assert DOC["loosen"] == tp.LOOSEN
    assert DOC["loosen_cases"] == tp.LOOSEN_CASES
    assert DOC["refresh_pressure_run"] == tp.REFRESH_PRESSURE
    assert DOC["mutation_run"] == tp.MUTATION_RUN
    assert set(DOC["properties"]) == set(tp.PROPERTY_CASES)
    assert set(DOC["cli"]) == set(tp.CLI_RUNS)
    assert set(DOC["golden"]) == set(tp.golden_systems())
    # phase 17 runs these very objects
    assert _chip_smoke().parity() is tp


def test_reference_side_is_current():
    from repro import verify
    from repro.core import ControllerConfig
    from repro.verify import spec_mutation as SM
    configs = importlib.import_module("repro.verify.explore").SMOKE_CONFIGS
    res = verify.smoke(("DDR4",), tuple(c for c in configs
                                        if c[0] == "b4-q2"))
    assert tp.explore_doc(res[("DDR4", "b4-q2")]) == DOC["smoke"]["DDR4/b4-q2"]
    for case in tp.LOOSEN_CASES:
        row, r = tp.loosened_run(verify, ControllerConfig, case)
        assert tp.cex_doc(r, row) == DOC[case]
    assert {"/".join(k): v for k, v in SM.spec_mutation_matrix(
        ["DDR4"]).items()} == {k: v for k, v in
                               DOC["spec_mutation_matrix"].items()
                               if k.startswith("DDR4/")}
    fx = os.path.join(tp.HERE, "verify", "fixtures")
    rep = verify.diff_against_fixture("DDR5", os.path.join(
        fx, "DDR5.cmdstream"))
    assert tp.diff_doc(rep) == DOC["differential"]["reports"]["DDR5"]
