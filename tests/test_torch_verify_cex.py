"""PyTorch port, counterexample extraction (``repro_torch.verify``) on the
CPU against the reference's in ``tests/torch_verify_stats.json``, exactly.

A fast 2-bank DDR4 with its ACT->RD constraint loosened by one cycle
(``loosen_constraint``; the port's ``DynParams``, readiness keys and
step plan are built from the loosened table, the oracle from the
pristine one) must diverge:

* without the table check, as an illegal issue at the reference's depth,
  with the same 56 divergences, the same minimized path and the same
  trace columns and metadata;
* with the table check, one layer earlier, at the earliest-ready table.

The port's ``.npz`` counterexample is read back by both packages'
``load_counterexample`` and flagged by both auditors at slack -1.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import trace as JT                              # noqa: E402
from repro import verify as JV                             # noqa: E402
from repro_torch import trace as TT                        # noqa: E402
from repro_torch import verify                             # noqa: E402
from repro_torch.core import ControllerConfig              # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))


@pytest.fixture(scope="module")
def counterexample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cex"))
    row, res = tp.loosened_run(verify, ControllerConfig, "counterexample",
                               artifact_dir=d, device="cpu")
    return row, res


def test_miscompiled_spec_gives_the_references_counterexample(
        counterexample):
    row, res = counterexample
    want = DOC["counterexample"]
    assert tp.cex_doc(res, row) == want
    assert not res.ok and res.divergences[0].kind == "illegal_issue"
    cex = res.counterexample
    # minimal: one request, then no-ops to the failing cycle
    assert sum(1 for c in cex.path if c != 0) == 1
    assert len(cex.path) == cex.divergence.depth + 1
    assert int(cex.trace.clk[-1]) == cex.divergence.depth


def test_counterexample_artifact_replays_in_both_packages(counterexample):
    row, res = counterexample
    path = res.counterexample.artifact
    assert path and path.endswith(".npz")
    oracle = verify.tiny_spec("DDR4", banks=2, fast=True)
    lat = int(oracle.ct_lat[row])
    docs = []
    for tr_mod, load_cex, spec in ((TT, verify.load_counterexample, oracle),
                                   (JT, JV.load_counterexample, None)):
        tr = tr_mod.load(path)
        if spec is None:
            spec = JV.tiny_spec("DDR4", banks=2, fast=True)
        rep = tr_mod.audit(spec, tr, check_fingerprint=True)
        docs.append(tp.audit_doc(rep))
        hits = [v for v in rep.violations
                if v.prev_cmd == "ACT" and v.cmd == "RD" and v.slack == -1
                and f"lat={lat}" in v.constraint]
        assert hits, [str(v) for v in rep.violations[:5]]
        cspec2, tr2 = load_cex(path)
        assert not tr_mod.audit(cspec2, tr2).ok
        meta = tr2.meta["counterexample"]
        assert meta["divergence"]["kind"] == "illegal_issue"
        assert meta["path"] == [int(c) for c in res.counterexample.path]
    assert docs[0] == docs[1]


def test_table_divergence_also_caught():
    row, res = tp.loosened_run(verify, ControllerConfig, "table_divergence",
                               device="cpu")
    assert tp.cex_doc(res, row) == DOC["table_divergence"]
    assert res.divergences[0].kind == "earliest_mismatch"
    assert res.counterexample is not None


def test_loosened_copy_is_the_references():
    t = verify.tiny_spec("DDR4", banks=2, fast=True)
    j = JV.tiny_spec("DDR4", banks=2, fast=True)
    (tb, trow), (jb, jrow) = (verify.loosen_constraint(t),
                              JV.loosen_constraint(j))
    assert trow == jrow
    np.testing.assert_array_equal(tb.ct_lat, jb.ct_lat)
    assert int(tb.ct_lat[trow]) == int(t.ct_lat[trow]) - 1
    # the pristine spec is untouched
    assert int(t.ct_lat[trow]) == int(j.ct_lat[jrow])
    with pytest.raises(ValueError, match="no loosenable"):
        verify.loosen_constraint(t, "RD", "ACT")
