"""PyTorch port, end-to-end parity of specs no other test runs through
the engine: a ``timing_overrides`` run, the two-rank DDR4 org preset and
the DDR4 VRR standard, each a run whose ``Stats.to_dict()`` and
command-stream sha256 equal the JAX package's (tolerance 0)."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_config                      # noqa: E402

SPECS = {
    "timing_overrides": dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                             timing_preset="DDR4_2400R",
                             timing_overrides={"nRCD": 20, "nRP": 20}),
    "two_rank": dict(standard="DDR4", org_preset="DDR4_8Gb_x8_2R",
                     timing_preset="DDR4_2400R"),
    "ddr4_vrr": dict(standard="DDR4_VRR", org_preset="DDR4_8Gb_x8",
                     timing_preset="DDR4_2400R"),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_equals_reference(name):
    stats = check_config(SPECS[name], interval=2.0, read_ratio=0.7)
    assert stats.reads_done > 0
