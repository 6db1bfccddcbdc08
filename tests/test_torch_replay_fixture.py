"""PyTorch port, the fixture of the card's replay sessions:
``tests/torch_replay_stats.json`` holds the JAX package's replay runs —
a DDR4 source run (4,000 cycles, interval 4.0, read ratio 0.5) captured
and turned into a paced stream with dependencies (its fingerprint),
replayed 20,000 cycles without probes (``Stats`` and command-stream
sha256); the same for the DDR5x2 + CXL-DDR4x2@80 system with probes; and
``run_batch`` at intervals [8, 2] over the DDR4 stream without its
arrival clocks.  It is regenerated here with the JAX package so it cannot
drift; ``chip_smoke.py`` phase 15 holds the port to it on the card."""
import json

import pytest

pytest.importorskip("torch")

from torch_parity import REPLAY_FIXTURE, replay_fixture    # noqa: E402


def test_replay_fixture_is_current():
    doc = json.load(open(REPLAY_FIXTURE))
    assert doc == json.loads(json.dumps(replay_fixture()))
    # the sessions exercise the pacing, the holds and the batch
    assert doc["replay"]["stats"]["skipped_cycles"] > 0
    assert doc["hetero"]["stats"]["probe_cnt"] > 0
    assert len(doc["batch"]["stats"]) == 2
