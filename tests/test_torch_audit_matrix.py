"""PyTorch port, the mutation matrices on the CPU against the reference's
(``tests/torch_verify_stats.json``), exactly.

* The trace auditor's matrix covers every standard and class; its table,
  rendered by the port's ``matrix_table`` from the cells, equals the
  reference's (the cells themselves are held per golden trace beside
  its golden hash, in ``test_torch_golden_*.py``).
* The spec linter's matrix (``repro_torch.verify.spec_mutation``, the
  seven mutators over every registered standard on the port's linter)
  equals the reference's cell for cell, with 100% detection.
* Injection and detection on one synthetic quiet trace equal the
  reference's for every class.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.verify import mutation as JM                    # noqa: E402
from repro.verify import spec_mutation as JSM              # noqa: E402
from repro_torch import verify                             # noqa: E402
from repro_torch.verify import mutation as TM              # noqa: E402
from repro_torch.verify import spec_mutation as TSM        # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))


def test_matrix_covers_every_standard_and_class_and_renders():
    cells = DOC["mutation_matrix"]["cells"]
    stds = set(tp.golden_systems())
    assert {k.split("/")[0] for k in cells} == stds
    assert {k.split("/")[1] for k in cells} == set(TM.CLASSES)
    assert set(cells.values()) == {"detected"}
    matrix = {tuple(k.split("/")): v for k, v in cells.items()}
    assert TM.matrix_table(matrix) == DOC["mutation_matrix"]["table"]
    assert TM.CLASSES == JM.CLASSES


@pytest.mark.parametrize("std", tp.all_standard_names())
def test_spec_mutation_row_equals_the_references(std):
    got = {"/".join(k): v for k, v in
           TSM.spec_mutation_matrix([std]).items()}
    want = {k: v for k, v in DOC["spec_mutation_matrix"].items()
            if k.split("/")[0] == std}
    assert got == want and len(got) == len(TSM.MUTATORS)


def test_spec_mutators_fire_the_references_rules():
    for name in sorted(TSM.MUTATORS):
        t, j = TSM.inject("DDR4", name), JSM.inject("DDR4", name)
        assert (t.mutator, t.rule, t.standard, t.detail) == \
            (j.mutator, j.rule, j.standard, j.detail)
        assert [f.rule for f in t.hits()] == [f.rule for f in j.hits()]
        assert TSM.detected(t) and len(t.hits()) == 1
    assert sorted(TSM.MUTATORS) == sorted(JSM.MUTATORS)


def _quiet_trace(pkg_trace, cspec, cls_kw):
    """A short legal stream: ACT, RD, PRE on bank 0 with wide gaps."""
    lat = max(int(np.max(cspec.ct_lat)), 1) + 4
    names = list(cspec.cmd_names)
    cmds = [names.index("ACT"), names.index("RD"), names.index("PRE")]
    col = lambda v: np.asarray(v, np.int32)
    return pkg_trace.CommandTrace(
        clk=col([0, lat, 2 * lat]), cmd=col(cmds), bank=col([0, 0, 0]),
        row=col([1, 1, 1]), bus=col([0, 0, 0]), arrive=col([-1, 0, -1]),
        hit_ready=col([0, 0, 0]), n_cycles=3 * lat, cmd_names=names,
        **cls_kw)


@pytest.mark.parametrize("klass", TM.CLASSES)
def test_injection_on_a_quiet_trace_equals_the_references(klass):
    from repro import trace as JT
    from repro.core import compile_spec as jcompile
    from repro_torch import trace as TT
    from repro_torch.core import compile_spec as tcompile
    args = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    tc, jc = tcompile(*args), jcompile(*args)
    ti = TM.inject(tc, _quiet_trace(TT, tc, dict(chan=None)), klass)
    ji = JM.inject(jc, _quiet_trace(JT, jc, {}), klass)
    assert (ti.row, ti.prev, ti.next, ti.lat, ti.win, ti.mode) == \
        (ji.row, ji.prev, ji.next, ji.lat, ji.win, ji.mode)
    assert tp.trace_digest(ti.trace)["sha256"] == \
        tp.trace_digest(ji.trace)["sha256"]
    assert TM.detected(tc, ti) and JM.detected(jc, ji)
    assert tp.audit_doc(TT.audit(tc, ti.trace, check_fingerprint=False)) == \
        tp.audit_doc(JT.audit(jc, ji.trace, check_fingerprint=False))
