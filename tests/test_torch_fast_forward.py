"""PyTorch port, engine: fast-forward over idle cycles.

The golden configuration keeps the queue saturated, so every cycle there
executes.  At a low load most cycles are idle: the port must skip the
same cycles as the reference (same ``scan_steps``/``skipped_cycles``),
give the same ``Stats`` and the same command stream, and read the device
exactly once per executed step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ControllerConfig as JCfg            # noqa: E402
from repro.core import Simulator as JSim                   # noqa: E402
from repro.trace import capture as j_capture                # noqa: E402

from repro_torch.core import ControllerConfig, Simulator    # noqa: E402
from repro_torch.trace import capture                       # noqa: E402

from torch_parity import TRIO, trace_sha256                 # noqa: E402

LOADS = [dict(interval=64.0, read_ratio=0.5),
         dict(interval=9.5, read_ratio=0.9)]


@pytest.mark.parametrize("std,org,tim", TRIO)
@pytest.mark.parametrize("li", range(len(LOADS)))
def test_low_load_skips_like_reference(std, org, tim, li):
    load = LOADS[li]
    jsim = JSim(std, org, tim, controller=JCfg(scheduler="FRFCFS"))
    jstats, jdense = jsim.run(2500, trace=True, seed=0x5151, **load)
    sim = Simulator(std, org, tim, device="cpu",
                    controller=ControllerConfig(scheduler="FRFCFS"))
    stats, dense = sim.run(2500, trace=True, seed=0x5151, **load)
    got, want = stats.to_dict(), jstats.to_dict()
    assert got == want
    assert got["skipped_cycles"] > 0
    assert sim.host_syncs == got["scan_steps"]
    assert trace_sha256(capture(sim.cspec, dense)) \
        == trace_sha256(j_capture(jsim.cspec, jdense))
    for a, b in zip(jdense, dense):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_per_cycle_loop_never_syncs():
    std, org, tim = TRIO[0]
    sim = Simulator(std, org, tim, device="cpu", fast_forward=False)
    stats = sim.run(300, interval=64.0, read_ratio=0.5)
    assert sim.host_syncs == 0 and stats.scan_steps == 300
    ff = Simulator(std, org, tim, device="cpu").run(300, interval=64.0,
                                                    read_ratio=0.5)
    a, b = stats.to_dict(), ff.to_dict()
    for d in (a, b):
        d.pop("scan_steps")
        d.pop("skipped_cycles")
    assert a == b
