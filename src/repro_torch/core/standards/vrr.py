"""Victim-Row-Refresh variants — the paper's Listing 1, verbatim pattern.

Each variant is <20 lines: inherit, append the VRR command, append its
timing constraints, and derive the nVRR preset value from tCK.
"""
import math

from repro_torch.core.spec import Command, TimingConstraint, KIND_ROW, register
from repro_torch.core.standards.ddr4 import DDR4
from repro_torch.core.standards.ddr5 import DDR5


def _with_vrr(base, name):
    class _VRR(base):
        pass
    _VRR.__name__ = _VRR.__qualname__ = name
    _VRR.name = name
    _VRR.command_meta = dict(base.command_meta, VRR=Command("VRR", "bank", KIND_ROW))
    _VRR.commands = base.commands + ["VRR"]
    _VRR.timing_params = base.timing_params + ["nVRR"]
    _VRR.timing_constraints = list(base.timing_constraints) + [
        TimingConstraint(level="bank", preceding=["VRR"], following=["ACT"], latency="nVRR"),
        TimingConstraint(level="bank", preceding=["ACT"], following=["VRR"], latency="nRC"),
        TimingConstraint(level="rank", preceding=["PRE", "PREab"], following=["VRR"], latency="nRP"),
    ]
    _VRR.org_presets = base.org_presets
    _VRR.timing_presets = {}
    for _name, _timings in base.timing_presets.items():
        _vrr = dict(_timings)
        _vrr["nVRR"] = math.ceil(280_000 / _timings["tCK_ps"])   # 280 ns
        _VRR.timing_presets[_name] = _vrr
    return register(_VRR)


DDR4_VRR = _with_vrr(DDR4, "DDR4_VRR")
DDR5_VRR = _with_vrr(DDR5, "DDR5_VRR")
