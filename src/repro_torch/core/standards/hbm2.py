"""HBM2 — pseudo-channel organization, single C/A bus."""
from repro_torch.core.spec import DRAMSpec, Organization, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class HBM2(DRAMSpec):
    name = "HBM2"
    levels = ("channel", "pseudochannel", "bankgroup", "bank")
    refresh_level = "pseudochannel"
    burst_beats = 4     # BL4 on a 128-bit (x64 per pseudo-channel) bus
    command_meta = base_commands(refresh_level="pseudochannel")
    commands = list(command_meta)
    timing_params = base_timing_params()
    timing_constraints = base_constraints(refresh_level="pseudochannel")
    org_presets = {
        "HBM2_8Gb": Organization(8192, 64, {"pseudochannel": 2, "bankgroup": 4, "bank": 4}, rows=1 << 14, columns=1 << 6),
    }
    timing_presets = {
        "HBM2_2Gbps": dict(
            tCK_ps=1000, nBL=2, nCL=14, nCWL=4, nRCD=14, nRP=14, nRAS=33,
            nRC=47, nWR=16, nRTP=4, nCCD_S=2, nCCD_L=3, nRRD_S=4, nRRD_L=6,
            nWTR_S=6, nWTR_L=8, nFAW=16, nRFC=260, nREFI=3900,
        ),
    }
