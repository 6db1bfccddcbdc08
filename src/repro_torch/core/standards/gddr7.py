"""GDDR7 — dual C/A bus (parallel row/column issue) + RCK data-clock sync
(paper §2).  Values extrapolated from JESD239 public material."""
from repro_torch.core.spec import DRAMSpec, Organization, TimingConstraint, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class GDDR7(DRAMSpec):
    name = "GDDR7"
    levels = ("channel", "rank", "bankgroup", "bank")
    burst_beats = 16
    dual_command_bus = True
    data_clock_sync = True
    clock_sync_commands = {"read": "RCKSTRT", "write": "RCKSTRT"}
    command_meta = base_commands(clock_sync="rck")
    commands = list(command_meta)
    timing_params = base_timing_params(extra=("nRCKEN", "nRCKIDLE"))
    timing_constraints = base_constraints() + [
        TimingConstraint("rank", ["RCKSTRT"], ["RD", "WR"], "nRCKEN"),
        TimingConstraint("rank", ["RCKSTRT"], ["RCKSTRT"], "nRCKEN"),
    ]
    org_presets = {
        "GDDR7_16Gb_x32": Organization(16384, 32, {"rank": 1, "bankgroup": 4, "bank": 4}, rows=1 << 14, columns=1 << 10),
    }
    timing_presets = {
        "GDDR7_32": dict(   # 32 Gb/s/pin, CK = 1.25 GHz (extrapolated)
            tCK_ps=800, nBL=2, nCL=30, nCWL=10, nRCD=30, nRP=30, nRAS=64,
            nRC=94, nWR=30, nRTP=5, nCCD_S=2, nCCD_L=3, nRRD_S=4, nRRD_L=6,
            nWTR_S=7, nWTR_L=10, nFAW=20, nRFC=350, nREFI=2375,
            nRCKEN=2, nRCKIDLE=8,
        ),
    }
