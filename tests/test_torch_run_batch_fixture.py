"""PyTorch port, batched design points: the port's scalar runs and the
fixture of the card's batched session.

* ``run_batch``'s points equal the port's own scalar ``Simulator.run`` of
  each point (DDR4, 2 channels, 1,500 cycles).
* ``tests/torch_batch_stats.json`` holds the reference's ``run_batch`` of
  the batched latency-throughput session that ``chip_smoke.py`` holds the
  port to on the card (DDR4 with 4 channels, intervals [1, 1.5, 2, 3, 4,
  6, 8, 16] x read ratios [1.0, 0.8, 0.6, 0.5]: 32 points, 128 lanes;
  20,000 cycles, seed 0x1234); it is regenerated here with the JAX
  ``Simulator`` so it cannot drift.  The port's own 32-point run is
  checked on the card: on a CPU its plain step loops over the points.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Simulator                      # noqa: E402

from torch_parity import BATCH_FIXTURE, batch_fixture       # noqa: E402

SYS = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
RUN = dict(n_cycles=1500)


def test_points_equal_scalar_runs():
    """A light point (it skips idle cycles) and a saturated one."""
    sim = Simulator(*SYS, channels=2, device="cpu")
    pts, stats = sim.run_batch(RUN["n_cycles"], [16, 2], [0.5])
    assert stats.scan_steps[0] < stats.scan_steps[1]
    for i, (interval, ratio) in enumerate(pts):
        one = Simulator(*SYS, channels=2, device="cpu").run(
            RUN["n_cycles"], interval=interval, read_ratio=ratio)
        assert stats.point(i).to_dict() == one.to_dict(), (interval, ratio)


def test_batch_fixture_is_current():
    doc = json.load(open(BATCH_FIXTURE))
    assert doc == json.loads(json.dumps(batch_fixture()))
    assert len(doc["points"]) == 32 and doc["run"]["channels"] == 4
    assert [tuple(p) for p in doc["points"]] == [
        (i, r) for i in doc["run"]["intervals"]
        for r in doc["run"]["read_ratios"]]
