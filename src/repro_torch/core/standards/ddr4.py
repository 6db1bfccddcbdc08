"""DDR4 — bank groups, nCCD_S/L split."""
from repro_torch.core.spec import DRAMSpec, Organization, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class DDR4(DRAMSpec):
    name = "DDR4"
    levels = ("channel", "rank", "bankgroup", "bank")
    burst_beats = 8
    command_meta = base_commands()
    commands = list(command_meta)
    timing_params = base_timing_params()
    timing_constraints = base_constraints()
    org_presets = {
        "DDR4_8Gb_x8": Organization(8192, 8, {"rank": 1, "bankgroup": 4, "bank": 4}, rows=1 << 16, columns=1 << 10),
        "DDR4_8Gb_x8_2R": Organization(8192, 8, {"rank": 2, "bankgroup": 4, "bank": 4}, rows=1 << 16, columns=1 << 10),
    }
    timing_presets = {
        "DDR4_2400R": dict(
            tCK_ps=833, nBL=4, nCL=16, nCWL=12, nRCD=16, nRP=16, nRAS=32,
            nRC=48, nWR=18, nRTP=9, nCCD_S=4, nCCD_L=6, nRRD_S=4, nRRD_L=6,
            nWTR_S=3, nWTR_L=9, nFAW=26, nRFC=420, nREFI=9360,
        ),
        "DDR4_3200AA": dict(
            tCK_ps=625, nBL=4, nCL=22, nCWL=16, nRCD=22, nRP=22, nRAS=52,
            nRC=74, nWR=24, nRTP=12, nCCD_S=4, nCCD_L=8, nRRD_S=4, nRRD_L=8,
            nWTR_S=4, nWTR_L=12, nFAW=34, nRFC=560, nREFI=12480,
        ),
    }
