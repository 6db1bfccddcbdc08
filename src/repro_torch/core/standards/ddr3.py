"""DDR3 — baseline standard, no bank groups."""
from repro_torch.core.spec import DRAMSpec, Organization, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class DDR3(DRAMSpec):
    name = "DDR3"
    levels = ("channel", "rank", "bank")
    burst_beats = 8
    command_meta = base_commands()
    commands = list(command_meta)
    timing_params = base_timing_params(has_bankgroup=False)
    timing_constraints = base_constraints(has_bankgroup=False)
    org_presets = {
        "DDR3_4Gb_x8": Organization(4096, 8, {"rank": 2, "bank": 8}, rows=1 << 16, columns=1 << 10),
        "DDR3_8Gb_x8": Organization(8192, 8, {"rank": 2, "bank": 8}, rows=1 << 16, columns=1 << 11),
    }
    timing_presets = {
        "DDR3_1600K": dict(
            tCK_ps=1250, nBL=4, nCL=11, nCWL=8, nRCD=11, nRP=11, nRAS=28,
            nRC=39, nWR=12, nRTP=6, nCCD_S=4, nRRD_S=5, nWTR_S=6, nFAW=24,
            nRFC=208, nREFI=6240,
        ),
    }
