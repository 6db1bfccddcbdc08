"""PyTorch port, the fixture of the card's telemetry sessions:
``tests/torch_telemetry_stats.json`` holds the JAX package's ``Stats`` and
windows of the README's DDR5 session (20,000 cycles, interval 2.0, read
ratio 0.8) at ``W = 1000`` and of the DDR5x2 + CXL-DDR4x2@80 system
(4,000 cycles, interval 1.0, read ratio 0.7) at ``W = 256``.  It is
regenerated here with the JAX ``Simulator`` so it cannot drift;
``chip_smoke.py`` phase 15 holds the port to it on the card."""
import json

import pytest

pytest.importorskip("torch")

from torch_parity import (MAIN_FIXTURE, TELEMETRY_FIXTURE,  # noqa: E402
                          telemetry_fixture)


def test_telemetry_fixture_is_current():
    doc = json.load(open(TELEMETRY_FIXTURE))
    assert doc == json.loads(json.dumps(telemetry_fixture()))
    # the saturated session skips nothing, so its Stats are the main
    # path's with telemetry on or off
    stats = dict(doc["session"]["stats"])
    stats.pop("per_group")
    assert stats == json.load(open(MAIN_FIXTURE))["stats"]
    assert len(doc["session"]["telemetry"]["t_end"]) == 20
    assert [len(g["reads"][0]) for g in doc["hetero"]["telemetry"]
            ["groups"]] == [2, 2]
