"""Paper Listing 1 on the port: extend DDR5 with a Victim-Row-Refresh
(VRR) command + timing constraints in ~18 lines of user code, then verify
the new command's timing behavior on the device under test and on the
port's earliest-ready table (the counterpart of
``examples/extend_standard.py``).

    PYTHONPATH=src python examples/torch/extend_standard.py [--device cpu]
"""
import argparse
import math

import torch

from repro_torch import _device
from repro_torch.core.spec import (KIND_ROW, Command, TimingConstraint,
                                   register)
from repro_torch.core.standards.ddr5 import DDR5


# ---- the user extension (the paper's Listing 1) --------------------------
@register
class DDR5_VRR_Example(DDR5):
    name = "DDR5_VRR_Example"
    command_meta = dict(DDR5.command_meta, VRR=Command("VRR", "bank", KIND_ROW))
    commands = DDR5.commands + ["VRR"]
    timing_params = DDR5.timing_params + ["nVRR"]
    timing_constraints = DDR5.timing_constraints + [
        TimingConstraint(level="bank", preceding=["VRR"], following=["ACT"],
                         latency="nVRR"),
        TimingConstraint(level="bank", preceding=["ACT"], following=["VRR"],
                         latency="nRC"),
        TimingConstraint(level="rank", preceding=["PRE", "PREab"],
                         following=["VRR"], latency="nRP"),
    ]
    org_presets = DDR5.org_presets
    timing_presets = {}


for _name, _timings in DDR5.timing_presets.items():
    _vrr = dict(_timings)
    _vrr["nVRR"] = math.ceil(280_000 / _timings["tCK_ps"])
    DDR5_VRR_Example.timing_presets[_name] = _vrr
# ---- end extension --------------------------------------------------------


def device_earliest(dut, addr, device) -> int:
    """ACT's earliest cycle at ``addr`` after the VRR issued at cycle 0,
    from the port's dense earliest-ready table on ``device`` (the
    readiness kernel on the card)."""
    from repro_torch.core import device as D
    cspec = dut.cspec
    dp = D.dyn_params(cspec, device)
    sub = torch.tensor([[addr[lv] for lv in cspec.levels[1:]]],
                       dtype=torch.int32, device=device)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=device)
    state = D.issue(cspec, dp, D.init_state(cspec, 1, device),
                    i32(cspec.cmd_id("VRR")), sub, i32(addr["row"]), 0,
                    torch.ones(1, dtype=torch.bool, device=device))
    table = D.earliest_ready_table(cspec, dp, state)     # (1, cmds, banks)
    return int(table[0, cspec.cmd_id("ACT"), dut._bank(addr)])


def main(argv=None) -> dict:
    from repro_torch.core import DeviceUnderTest
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    dut = DeviceUnderTest("DDR5_VRR_Example", "DDR5_16Gb_x8", "DDR5_4800B")
    addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=5, Column=0)
    print("nVRR =", dut.timings["nVRR"], "cycles")
    dut.issue("VRR", addr, clk=0)
    blocked = dut.probe("ACT", addr, clk=dut.timings["nVRR"] - 1)
    legal = dut.probe("ACT", addr, clk=dut.timings["nVRR"])
    print(f"ACT at nVRR-1: timing_OK={blocked.timing_OK}  (expect False)")
    print(f"ACT at nVRR:   timing_OK={legal.timing_OK}  (expect True)")
    assert not blocked.timing_OK and legal.timing_OK
    table = device_earliest(dut, addr, device)
    print(f"earliest-ready table on {device.type}: ACT after VRR at cycle "
          f"{table}  (expect {dut.earliest('ACT', addr)})")
    assert table == dut.earliest("ACT", addr) == dut.timings["nVRR"]
    print("VRR extension behaves correctly.")
    return dict(nVRR=int(dut.timings["nVRR"]), blocked=blocked, legal=legal,
                table=table)


if __name__ == "__main__":
    main()
