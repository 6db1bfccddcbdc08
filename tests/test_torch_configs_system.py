"""PyTorch port, end-to-end parity of systems no other test runs through
the engine: 3 and 4 channels with refresh stagger off and the
``RoRaBaCoCh`` mapper, the ``DDR4_3200AA`` timing preset, the
``DDR3_4Gb_x8`` org preset and a 2-channel ``DDR5_VRR``,
each a run whose ``Stats.to_dict()`` and command-stream sha256 equal the
JAX package's (tolerance 0)."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_config                      # noqa: E402

NO_STAGGER = dict(refresh_stagger=False)
#: name -> (Simulator arguments, controller)
SYSTEMS = {
    "ddr4_3ch_no_stagger": (dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                                 timing_preset="DDR4_2400R", channels=3,
                                 mapper="RoRaBaCoCh"), NO_STAGGER),
    "hbm3_4ch_no_stagger": (dict(standard="HBM3", org_preset="HBM3_16Gb",
                                 timing_preset="HBM3_5200", channels=4,
                                 mapper="RoRaBaCoCh"), NO_STAGGER),
    "ddr4_3200aa": (dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                         timing_preset="DDR4_3200AA"), None),
    "ddr3_4gb": (dict(standard="DDR3", org_preset="DDR3_4Gb_x8",
                      timing_preset="DDR3_1600K"), None),
    "ddr5_vrr_2ch": (dict(standard="DDR5_VRR", org_preset="DDR5_16Gb_x8",
                          timing_preset="DDR5_4800B", channels=2), None),
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_system_equals_reference(name):
    sim_kw, ctl = SYSTEMS[name]
    stats = check_config(sim_kw, n_cycles=1000, controller=ctl,
                         interval=1.5, read_ratio=0.7)
    assert stats.reads_done > 0
