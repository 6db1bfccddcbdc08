"""PyTorch port, ``repro_torch.dse.execute`` against ``repro.dse.execute``
(tolerance 0): a sweep of two compile groups, FR-FCFS and FCFS, over a
2-channel DDR4 system with the random address pattern (the re-anchor's
``run_batch`` with FCFS and the random pattern over 2 channels), every
point's columns, command counts and curves equal, one cache entry per
group; ``max_in_flight`` and ``devices`` are checked as the port
defines them."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_sweep                       # noqa: E402


def spec(pkg):
    return pkg.dse.SweepSpec(
        systems=("DDR4",), channels=(2,),
        controllers=(pkg.core.ControllerConfig(),
                     pkg.core.ControllerConfig(scheduler="FCFS")),
        frontend=pkg.core.FrontendConfig(pattern="random"),
        intervals=(8.0, 2.0), read_ratios=(0.7,), n_cycles=800)


def test_schedulers_over_two_channels_equal_reference():
    j, t = check_sweep(spec)
    assert t.meta["n_groups"] == 2 and t.meta["compile_cache_misses"] == 2
    assert t.meta["traces"] == 2 and t.meta["device"] == "cpu"
    assert [g["iterations"] for g in t.meta["groups"]] == [
        max(t.scan_steps[:2]), max(t.scan_steps[2:])]
    assert t.meta["host_syncs"] == sum(g["iterations"]
                                       for g in t.meta["groups"])
    assert t.meta["max_in_flight"] == 2 and t.meta["padded_points"] == 0
    spans = t.meta["profile"]["spans"]
    assert spans["dispatch"]["calls"] == spans["collect"]["calls"] == 2


def test_execute_refuses_what_the_port_does_not_take():
    from repro_torch import dse
    from torch_parity import packages
    s = spec(packages()[1])
    with pytest.raises(ValueError, match="max_in_flight"):
        dse.execute(s, devices=["cpu"], max_in_flight=0)
    with pytest.raises(ValueError, match="devices"):
        dse.execute(s, devices=[])
    with pytest.raises(NotImplementedError, match="item 12"):
        dse.execute(s, devices=["cpu", "cpu"])
