"""HBM3 — dual C/A bus: parallel row/column command issue (paper §2)."""
from repro_torch.core.spec import Organization, register
from repro_torch.core.standards.hbm2 import HBM2


@register
class HBM3(HBM2):
    name = "HBM3"
    dual_command_bus = True
    burst_beats = 8     # BL8 on a x64 pseudo-channel
    org_presets = {
        "HBM3_16Gb": Organization(16384, 64, {"pseudochannel": 2, "bankgroup": 4, "bank": 4}, rows=1 << 14, columns=1 << 6),
    }
    timing_presets = {
        "HBM3_5200": dict(  # 5.2 Gb/s/pin
            tCK_ps=770, nBL=2, nCL=20, nCWL=6, nRCD=18, nRP=18, nRAS=42,
            nRC=60, nWR=20, nRTP=5, nCCD_S=2, nCCD_L=4, nRRD_S=4, nRRD_L=6,
            nWTR_S=7, nWTR_L=10, nFAW=16, nRFC=338, nREFI=5070,
        ),
    }
