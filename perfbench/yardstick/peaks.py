"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity; NVIDIA's data sheet for the H100 SXM5 part at its 700 W
limit).  A card set below that limit reads lower: results carry its
``power.limit`` beside every share of a peak."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "fp32_flops": 66.9e12,
                              "tf32_flops": 494.7e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str):
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card not in the table: a share of a peak then reads
    nothing."""
    return PEAKS.get(kind)


def least_seconds(ops: float, byts: float, peak: dict,
                  flops_key: str = "bf16_flops") -> float:
    """The roofline's least time: the larger of operations over the peak
    rate and bytes over the memory bandwidth."""
    return max(ops / peak[flops_key], byts / peak["hbm_bytes"])
