"""PyTorch port, end-to-end parity of frontend configurations no other
test runs through the engine: probes off, the stream off, the random
pattern and a backlog cap of 2 arrivals, each a DDR4 run whose
``Stats.to_dict()`` and command-stream sha256 equal the JAX package's
(tolerance 0)."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_config                      # noqa: E402

DDR4 = dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
            timing_preset="DDR4_2400R")
FRONTENDS = {"probes_off": dict(probes=False),
             "stream_off": dict(stream=False),
             "random": dict(pattern="random"),
             "backlog_2": dict(max_backlog_fp=2 * 256)}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_frontend_config_equals_reference(name):
    stats = check_config(DDR4, frontend=FRONTENDS[name], interval=3.0,
                         read_ratio=0.6)
    if name == "stream_off":
        assert int(stats.reads_done) == int(stats.probe_cnt) > 0
    if name == "probes_off":
        assert int(stats.probe_cnt) == 0 and stats.reads_done > 0
