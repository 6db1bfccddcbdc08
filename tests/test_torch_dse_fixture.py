"""PyTorch port, the fixture of ``chip_smoke.py`` phase 16:
``tests/torch_dse_stats.json`` holds the reference's ``repro.dse.execute``
of the paper's Fig. 1 sweep (``benchmarks/bench_latency_throughput.py``'s
11 standards x 6 intervals x 3 read ratios, FR-FCFS, seed 0x1234) cut to
5,000 cycles, and of a two-point DDR4 ``capture_traces`` sweep.

* Its grid is the benchmark's and the constant ``chip_smoke.py`` runs
  (``torch_parity.DSE_FIG1``, imported in both places).
* The port on the CPU reproduces the cheapest group (fewest executed
  point-cycles in the fixture) at its two lightest intervals, six of its
  18 points, exactly: the plain step of the CPU loops over the points, so
  the whole group (~50,000 point-cycles) is left to the card.
* The two captured traces' digests reproduce on the CPU.
The fixture is rewritten by ``tests/torch_parity.py --write-sim-fixtures``.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")


def _module(relpath):
    """A script of the repository by path (neither the repository root nor
    ``benchmarks/`` is a package on the path)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), relpath)
    spec = importlib.util.spec_from_file_location(
        os.path.basename(relpath)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _module("chip_smoke.py")
fig1 = _module("benchmarks/bench_latency_throughput.py")

from repro_torch import dse                                 # noqa: E402
from repro_torch.core import ControllerConfig               # noqa: E402
from repro_torch.core import engine as E                    # noqa: E402
from repro_torch.trace import trace_sha256                  # noqa: E402

import torch_parity as tp                                   # noqa: E402

DOC = json.load(open(tp.DSE_FIXTURE))


def test_fixture_grid_is_the_benchmarks_and_the_smoke_scripts():
    run = DOC["fig1"]["run"]
    assert run == tp.DSE_FIG1
    assert chip_smoke.dse_fig1() is tp.DSE_FIG1
    assert [tuple(s) for s in run["systems"]] == fig1.STANDARDS
    assert tuple(run["intervals"]) == fig1.INTERVALS
    assert tuple(run["read_ratios"]) == fig1.READ_RATIOS
    assert (run["n_cycles"], run["seed"], run["scheduler"]) == \
        (5_000, 0x1234, "FRFCFS")
    assert DOC["fig1"]["n_groups"] == 11 and len(DOC["fig1"]["labels"]) == \
        11 * 6 * 3
    assert DOC["capture"]["run"] == tp.DSE_CAPTURE


def test_cheapest_group_light_points_reproduce_on_cpu():
    doc = DOC["fig1"]
    steps = np.asarray(doc["columns"]["scan_steps"]).reshape(11, 18)
    g = int(np.argmin(steps.sum(1)))
    system = tuple(doc["run"]["systems"][g])
    spec = dse.SweepSpec(
        systems=(system,), intervals=tuple(doc["run"]["intervals"][:2]),
        read_ratios=tuple(doc["run"]["read_ratios"]),
        n_cycles=doc["run"]["n_cycles"], seed=doc["run"]["seed"],
        controllers=(ControllerConfig(scheduler=doc["run"]["scheduler"]),))
    got = dse.execute(spec, cache=E.RunCache(), devices=["cpu"])
    rows = [doc["labels"].index(pt.label) for pt in got.points]
    assert rows == list(range(18 * g, 18 * g + 6))
    for k in tp.DSE_COLUMNS:
        want = np.asarray(doc["columns"][k])[rows]
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), want, k)
    assert [c.tolist() for c in got.cmd_counts] == \
        [doc["cmd_counts"][r] for r in rows]


def test_captured_digests_reproduce_on_cpu():
    doc = DOC["capture"]
    got = dse.execute(tp.sweep_spec(dse, doc["run"], capture_traces=True),
                      cache=E.RunCache(), devices=["cpu"])
    assert [dict(n=len(t), sha256=trace_sha256(t)) for t in got.traces] \
        == doc["traces"]
    for k in tp.DSE_COLUMNS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(doc["columns"][k]), k)
