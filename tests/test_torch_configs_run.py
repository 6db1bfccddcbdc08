"""PyTorch port, end-to-end parity of run options no other test runs
through the engine: a refresh urgency margin of 0, an even seed,
fast-forward off at light load and 20,000 mostly idle cycles (DDR4), and
the ``DDR5_6400AN`` timing preset, each a run whose ``Stats.to_dict()``
and command-stream sha256 equal the JAX package's (tolerance 0)."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_config                      # noqa: E402

DDR4 = dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
            timing_preset="DDR4_2400R")
#: name -> (Simulator arguments, cycles, controller, run arguments)
RUNS = {
    "urgent_margin_0": (DDR4, 1500, dict(refresh_urgent_margin=0),
                        dict(interval=2.0, read_ratio=0.7)),
    "even_seed": (DDR4, 1500, None, dict(interval=3.0, read_ratio=0.6,
                                         seed=0x2468)),
    "no_fast_forward_light": (dict(DDR4, fast_forward=False), 1200, None,
                              dict(interval=24.0, read_ratio=0.5)),
    "idle_20k": (DDR4, 20_000, None, dict(interval=400.0, read_ratio=0.9)),
    "ddr5_6400an": (dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                         timing_preset="DDR5_6400AN"), 1000, None,
                    dict(interval=1.5, read_ratio=0.7)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_option_equals_reference(name):
    sim_kw, n, ctl, run = RUNS[name]
    stats = check_config(sim_kw, n_cycles=n, controller=ctl, **run)
    assert stats.reads_done > 0
    if name == "idle_20k":
        assert stats.skipped_cycles > stats.scan_steps
