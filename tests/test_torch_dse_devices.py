"""PyTorch port, ``repro_torch.dse.execute(devices=[...])`` over several
devices: each group's points split over the listed devices (a device may
repeat), padded by repeating the last point and the padding dropped,
against the one-device sweep: every column, command count and the
accounting.  Exact."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch import dse                                     # noqa: E402
from repro_torch.core import ControllerConfig, FrontendConfig  # noqa: E402
from repro_torch.core import engine as E                        # noqa: E402

SPEC = dse.SweepSpec(systems=("DDR4",), channels=(2,),
                     controllers=(ControllerConfig(scheduler="FCFS"),),
                     frontend=FrontendConfig(pattern="random"),
                     intervals=(8.0, 4.0, 2.0), read_ratios=(0.7, 1.0),
                     n_cycles=300)
COLUMNS = ("throughput_gbps", "latency_ns", "peak_gbps", "reads_done",
           "writes_done", "probe_cnt", "deferred", "cycles", "scan_steps",
           "skipped_cycles")


@pytest.fixture(scope="module")
def one():
    return dse.execute(SPEC, cache=E.RunCache(), devices=["cpu"])


#: device lists: a repeated device (one cache entry) and two distinct ones
#: (an entry each)
DEVICES = {"cpu*2": ["cpu"] * 2, "cpu*4": ["cpu"] * 4,
           "cpu+cpu:0": ["cpu", "cpu:0"]}


@pytest.mark.parametrize("devices", DEVICES.values(), ids=DEVICES)
def test_split_over_devices_equals_one_device(one, devices):
    n = len(devices)
    got = dse.execute(SPEC, cache=E.RunCache(), devices=devices)
    for k in COLUMNS:
        np.testing.assert_array_equal(getattr(got, k), getattr(one, k),
                                      err_msg=k)
    for a, b in zip(got.cmd_counts, one.cmd_counts):
        np.testing.assert_array_equal(a, b)
    # 6 points: 4 devices pad 2, 2 devices none
    pad = (-6) % n
    assert [g["padded"] for g in got.meta["groups"]] == [pad]
    assert got.meta["padded_points"] == pad
    assert got.meta["n_devices"] == n
    assert got.meta["n_points"] == one.meta["n_points"] == 6
    # one entry and one lookup per (group, device): a repeated device
    # shares them
    distinct = len(set(devices))
    assert got.meta["cache"]["entries"] == distinct
    assert (got.meta["compile_cache_misses"],
            got.meta["compile_cache_hits"]) == (distinct, 0)


def test_no_devices_raises():
    with pytest.raises(ValueError, match="devices"):
        dse.execute(SPEC, devices=[])
