"""PyTorch port, engine: the per-cycle loop and the main-path fixture.

* With fast-forward off, the port's per-cycle loop reproduces the golden
  command streams of DDR4, LPDDR5 and HBM3 and executes every cycle.
* ``tests/torch_main_path_stats.json`` holds the reference's ``Stats`` of
  the README session (DDR5_16Gb_x8 / DDR5_4800B, 20,000 cycles, interval
  2.0, read ratio 0.8, seed 0x1234) that ``chip_smoke.py`` holds the port
  to on the card; it is regenerated here with the JAX ``Simulator`` so it
  cannot drift.  The port's own 20,000-cycle run is checked on the card
  by ``chip_smoke.py``: on a CPU it takes about a minute.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_parity import (GOLDEN, MAIN_FIXTURE, TRIO,       # noqa: E402
                          check_golden)


def _fixture():
    return json.load(open(MAIN_FIXTURE))


@pytest.mark.parametrize("std", [s for s, _, _ in TRIO])
def test_golden_command_stream_per_cycle_loop(std):
    stats = check_golden(std, fast_forward=False).to_dict()
    assert stats["scan_steps"] == 3000 and stats["skipped_cycles"] == 0
    assert sum(stats["cmd_counts"]) == GOLDEN[std]["n"]


def test_main_path_fixture_is_current():
    from repro.core import Simulator
    doc = _fixture()
    run = doc["run"]
    stats = Simulator(run["standard"], run["org_preset"],
                      run["timing_preset"]).run(
        run["n_cycles"], interval=run["interval"],
        read_ratio=run["read_ratio"], seed=run["seed"])
    assert stats.to_dict() == doc["stats"]
    assert run == dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                       timing_preset="DDR5_4800B", n_cycles=20_000,
                       interval=2.0, read_ratio=0.8, seed=0x1234)
