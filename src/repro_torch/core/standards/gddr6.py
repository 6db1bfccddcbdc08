"""GDDR6 — high-frequency graphics DRAM, single C/A bus."""
from repro_torch.core.spec import DRAMSpec, Organization, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class GDDR6(DRAMSpec):
    name = "GDDR6"
    levels = ("channel", "rank", "bankgroup", "bank")
    burst_beats = 16
    command_meta = base_commands()
    commands = list(command_meta)
    timing_params = base_timing_params()
    timing_constraints = base_constraints()
    org_presets = {
        "GDDR6_8Gb_x16": Organization(8192, 16, {"rank": 1, "bankgroup": 4, "bank": 4}, rows=1 << 14, columns=1 << 10),
    }
    timing_presets = {
        "GDDR6_16": dict(   # 16 Gb/s/pin, CK = 1 GHz
            tCK_ps=1000, nBL=2, nCL=24, nCWL=8, nRCD=24, nRP=24, nRAS=52,
            nRC=76, nWR=24, nRTP=4, nCCD_S=2, nCCD_L=3, nRRD_S=4, nRRD_L=6,
            nWTR_S=6, nWTR_L=8, nFAW=16, nRFC=280, nREFI=1900,
        ),
    }
