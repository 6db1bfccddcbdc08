"""PyTorch port, the differential layer (``repro_torch.verify.differential``)
on the CPU: the port's ``Simulator`` reproduces the three pinned
``tests/verify/fixtures/{DDR4,DDR5,HBM3}.cmdstream`` streams exactly (at
each standard's default organisation, full width, 1,500 cycles), its
``dump_cmd_stream`` text equals the fixture file byte for byte (the
reference's dump, digested in ``tests/torch_verify_stats.json``), and
its reports and accuracy table equal the reference's; the comparator
finds divergences as the reference's does.
"""
import json
import os

import pytest

pytest.importorskip("torch")

from repro.verify import differential as JD                # noqa: E402
from repro_torch.verify import differential as TD          # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))["differential"]
FIXTURES = os.path.join(os.path.dirname(__file__), "verify", "fixtures")


@pytest.fixture(scope="module")
def runs():
    return {s: TD.golden_run(s, device="cpu") for s in tp.VERIFY_STANDARDS}


@pytest.mark.parametrize("standard", tp.VERIFY_STANDARDS)
def test_dump_equals_the_fixture_byte_for_byte(runs, standard):
    text = TD.dump_cmd_stream(*runs[standard])
    path = os.path.join(FIXTURES, f"{standard}.cmdstream")
    assert text == open(path).read()
    assert tp.sha(text) == DOC["dumps"][standard]


def test_reports_and_accuracy_table_equal_the_references(runs):
    reports = []
    for std in tp.VERIFY_STANDARDS:
        golden = TD.parse_cmd_stream(os.path.join(FIXTURES,
                                                  f"{std}.cmdstream"))
        cur = TD.parse_cmd_stream(TD.dump_cmd_stream(*runs[std]))
        rep = TD.compare_streams(std, golden, cur)
        assert rep.exact and rep.n_golden > 100
        assert tp.diff_doc(rep) == DOC["reports"][std]
        reports.append(rep)
    assert TD.accuracy_table(reports) == DOC["table"]


def test_fixture_run_is_the_references():
    assert TD.FIXTURE_RUN == JD.FIXTURE_RUN


def test_diff_against_fixture_runs_on_cuda_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.diff_against_fixture("DDR4", os.path.join(FIXTURES,
                                                     "DDR4.cmdstream"))


def _toy(mod, lines):
    return mod.parse_cmd_stream("\n".join(lines))


@pytest.mark.parametrize("g,c", [
    (["0 ACT 0 0 0 5 0", "4 RD 0 0 0 5 0", "10 PREab 0 0 0 0 0"],
     ["0 ACT 0 0 0 5 0", "5 RD 0 0 0 5 0", "10 PREab 0 0 0 0 0"]),
    (["0 ACT 0 0 0 5 0", "4 RD 0 0 0 5 0"], ["0 ACT 0 0 0 5 0"]),
    (["0 ACT 0 0 0 5 0", "4 RD 0 0 0 5 0", "8 RD 0 0 0 5 1"],
     ["0 ACT 0 0 0 5 0", "4 WR 0 0 0 5 0", "8 RD 0 0 0 5 1"]),
])
def test_comparator_finds_what_the_references_finds(g, c):
    t = TD.compare_streams("toy", _toy(TD, g), _toy(TD, c))
    j = JD.compare_streams("toy", _toy(JD, g), _toy(JD, c))
    assert tp.diff_doc(t) == tp.diff_doc(j)
    assert not t.exact and t.first_divergence >= 1
    assert TD.accuracy_table([t]) == JD.accuracy_table([j])


def test_write_fixture_roundtrip(runs, tmp_path):
    """``write_fixture`` writes what ``parse_cmd_stream`` reads back into
    the same columns (the dump of the cached run)."""
    cspec, tr = runs["DDR4"]
    p = str(tmp_path / "x" / "DDR4.cmdstream")
    TD.dump_cmd_stream(cspec, tr, p)
    parsed = TD.parse_cmd_stream(p)
    assert parsed["clk"] == [int(c) for c in tr.clk]
    assert parsed["cmd"] == [tr.cmd_names[int(c)] for c in tr.cmd]
    assert all(len(a) == len(cspec.levels) + 2 for a in parsed["addr"])
    assert parsed["meta"]["standard"] == "DDR4"
