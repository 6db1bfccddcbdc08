"""DDR5 — BL16, two-cycle commands folded into timings."""
from repro_torch.core.spec import DRAMSpec, Organization, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class DDR5(DRAMSpec):
    name = "DDR5"
    levels = ("channel", "rank", "bankgroup", "bank")
    burst_beats = 16
    command_meta = base_commands()
    commands = list(command_meta)
    timing_params = base_timing_params()
    timing_constraints = base_constraints()
    org_presets = {
        "DDR5_16Gb_x8": Organization(16384, 8, {"rank": 1, "bankgroup": 8, "bank": 4}, rows=1 << 16, columns=1 << 10),
        "DDR5_16Gb_x8_2R": Organization(16384, 8, {"rank": 2, "bankgroup": 8, "bank": 4}, rows=1 << 16, columns=1 << 10),
    }
    timing_presets = {
        "DDR5_4800B": dict(
            tCK_ps=416, nBL=8, nCL=40, nCWL=38, nRCD=40, nRP=40, nRAS=76,
            nRC=116, nWR=72, nRTP=18, nCCD_S=8, nCCD_L=12, nRRD_S=8,
            nRRD_L=12, nWTR_S=13, nWTR_L=24, nFAW=32, nRFC=984, nREFI=9360,
        ),
        "DDR5_6400AN": dict(
            tCK_ps=312, nBL=8, nCL=52, nCWL=50, nRCD=52, nRP=52, nRAS=102,
            nRC=154, nWR=96, nRTP=24, nCCD_S=8, nCCD_L=16, nRRD_S=8,
            nRRD_L=16, nWTR_S=18, nWTR_L=32, nFAW=40, nRFC=1312, nREFI=12480,
        ),
    }
