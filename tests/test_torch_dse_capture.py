"""PyTorch port, ``repro_torch.dse`` against ``repro.dse`` (tolerance 0):

* ``capture_traces`` in memory and to a directory: each point's
  ``CommandTrace`` (columns, metadata, sha256) equals the reference's
  ``capture`` of its batched run, through one cache entry for the group
  (its points run one at a time), and the artifacts load in the
  reference;
* the cache's accounting: a second ``execute`` of the same spec builds
  nothing (0 misses, one hit per group);
* ``SweepResult.save`` read back by the reference's ``SweepResult.load``,
  and the other way round;
* ``sweep.main([..., "--device", "cpu"])`` against the reference's CLI.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.dse import SweepResult as JResult                # noqa: E402
from repro.dse import sweep as j_sweep                      # noqa: E402
from repro.trace import load as j_load                      # noqa: E402

from repro_torch.core import engine as E                    # noqa: E402
from repro_torch.dse import SweepResult, execute            # noqa: E402
from repro_torch.dse import sweep as t_sweep                # noqa: E402
from repro_torch.trace import trace_sha256                  # noqa: E402

from torch_parity import (assert_sweep_equal, check_sweep,  # noqa: E402
                          packages)


def spec(pkg, capture=True):
    return pkg.dse.SweepSpec(systems=("DDR4",), intervals=(6.0, 1.5),
                             read_ratios=(0.6,), n_cycles=500,
                             capture_traces=capture)


def test_captured_traces_equal_reference(tmp_path):
    d = str(tmp_path / "traces")
    builds = E.TRACE_COUNT
    j, t = check_sweep(lambda pkg: spec(pkg, d if "torch" in
                                        pkg.dse.__name__ else True))
    assert E.TRACE_COUNT == builds + 1       # one entry for the group
    assert t.meta["compile_cache_misses"] == 1
    for i, (jt, tt) in enumerate(zip(j.traces, t.traces)):
        assert trace_sha256(tt) == trace_sha256(jt)
        for f in ("clk", "cmd", "bank", "row", "bus", "arrive",
                  "hit_ready", "chan", "group"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
        assert tt.meta == jt.meta and tt.meta["point_index"] == i
        back = j_load(t.meta["trace_artifacts"][i])
        assert trace_sha256(back) == trace_sha256(jt)
        assert back.meta == jt.meta


def test_second_execute_only_hits_and_artifacts_cross(tmp_path):
    jp, tp = packages()
    cache = E.RunCache()
    s = spec(tp, capture=False)
    first = execute(s, cache=cache, devices=["cpu"])
    again = execute(s, cache=cache, devices=["cpu"])
    assert (first.meta["compile_cache_misses"],
            first.meta["compile_cache_hits"]) == (1, 0)
    assert (again.meta["compile_cache_misses"],
            again.meta["compile_cache_hits"], again.meta["traces"]) == \
        (0, 1, 0)
    assert again.meta["cache"]["entries"] == 1
    np.testing.assert_array_equal(first.reads_done, again.reads_done)
    ref = jp.dse.execute(spec(jp, capture=False),
                         cache=jp.engine.RunCache())
    assert_sweep_equal(ref, first)
    # port -> reference and reference -> port
    back = JResult.load(first.save(str(tmp_path / "port")))
    other = SweepResult.load(ref.save(str(tmp_path / "ref")))
    for a, b in ((ref, back), (first, other)):
        for k in SweepResult._COLUMNS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert [c.tolist() for c in a.cmd_counts] == \
            [c.tolist() for c in b.cmd_counts]
        assert [p.label for p in a.points] == [p.label for p in b.points]
    assert other.points == first.points
    assert (tmp_path / "port.json").read_text().split('"meta"')[0] == \
        (tmp_path / "ref.json").read_text().split('"meta"')[0]


def test_sweep_cli_equals_reference(tmp_path, capsys):
    args = ["--standards", "DDR4", "--intervals", "8,2", "--ratios",
            "1.0,0.5", "--cycles", "300", "--scheduler", "FCFS"]
    ref = j_sweep.main(args + ["--out", str(tmp_path / "ref")])
    j_out = capsys.readouterr().out
    port = t_sweep.main(args + ["--out", str(tmp_path / "port"),
                                "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert_sweep_equal(ref, port)
    # the table and the curve lines are the reference's
    table = lambda out: out.split("\n\n")[0]
    curves = lambda out: [ln for ln in out.splitlines()
                          if "peak_frac" in ln]
    assert table(t_out) == table(j_out) and curves(t_out) == curves(j_out)
    assert "(cpu;" in t_out
    loaded = SweepResult.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(loaded.throughput_gbps,
                                  ref.throughput_gbps)
    assert t_sweep.build_parser().parse_args([]).device == "cuda"
