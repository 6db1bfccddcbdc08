"""PyTorch port, the fixture of the card's system and predicate sessions:
``tests/torch_hetero_stats.json`` holds the JAX package's results of
``examples/hetero_system.py``'s session (DDR5x2 + CXL-DDR4x2@80, 20,000
cycles, interval 1.0, read ratio 0.7), ``run_batch`` over that system
(intervals 8.0 and 2.0 at read ratio 1.0, 4,000 cycles) and the predicate
sessions of ``benchmarks/bench_features.py`` (BlockHammer on a 2-row
hammer and on benign traffic, PRAC on 4 rows; 20,000 cycles) plus the
``no_writes_ever`` user predicate (4,000 cycles).  It is regenerated here
with the JAX ``Simulator`` so that it cannot drift; ``chip_smoke.py``
holds the port to it on the card (at these lengths the port's plain step
on the CPU would take minutes)."""
import json

import pytest

pytest.importorskip("torch")

from torch_parity import (HETERO_FIXTURE, PREDICATE_RUNS,  # noqa: E402
                          hetero_fixture)


def test_hetero_fixture_is_current():
    doc = json.load(open(HETERO_FIXTURE))
    assert doc == json.loads(json.dumps(hetero_fixture()))
    assert sorted(doc["predicates"]) == sorted(PREDICATE_RUNS)
    assert [tuple(p) for p in doc["batch"]["points"]] == [
        (i, r) for i in doc["batch"]["run"]["intervals"]
        for r in doc["batch"]["run"]["read_ratios"]]
    # the predicates fire in the sessions the card checks
    assert all(p["stats"]["deferred"] > 0
               for p in doc["predicates"].values())
    assert len(doc["session"]["stats"]["per_group"]) == 2
