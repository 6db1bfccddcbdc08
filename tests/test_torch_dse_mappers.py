"""PyTorch port, ``repro_torch.dse.execute`` against ``repro.dse.execute``
(tolerance 0): a 3-channel HBM3 system at queue depth 16 without probes
(the re-anchor's ``run_batch`` with depth 16 and no probes, and over 3
channels) swept over two address-mapper orders, two compile groups
whose points, command counts and curves (NaN latencies: no probe
finishes) equal the reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import check_sweep                       # noqa: E402


def spec(pkg):
    return pkg.dse.SweepSpec(
        systems=("HBM3",), channels=(3,),
        mappers=("RoCoBaRaCh", "RoBaRaCoCh"),
        controllers=(pkg.core.ControllerConfig(queue_depth=16),),
        frontend=pkg.core.FrontendConfig(probes=False),
        intervals=(4.0, 0.5), read_ratios=(0.8,), n_cycles=700)


def test_mappers_over_three_channels_equal_reference():
    j, t = check_sweep(spec)
    assert t.meta["n_groups"] == 2
    assert [g["mapper"] for g in t.meta["groups"]] == ["RoCoBaRaCh",
                                                       "RoBaRaCoCh"]
    assert np.isnan(t.latency_ns).all() and (t.probe_cnt == 0).all()
    assert (t.reads_done > 0).all()
