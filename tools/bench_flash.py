#!/usr/bin/env python3
"""Time the port's flash-attention kernels against
``scaled_dot_product_attention`` on one CUDA card.

    PYTHONPATH=src python tools/bench_flash.py [--reps 30] [--rounds 5]

For each shape (B, T, Hq, Hkv, D), bf16, causal or full, in the model's
(B, T, H, D) layout: the kernel ``flash_attention.route`` picks, timed
with CUDA events over ``--rounds`` batches of ``--reps`` back-to-back
calls after a warm-up (min and median per call), then SDPA with
``enable_gqa=True`` the same way (the library call: a yardstick, never
used by the port), then the kernel again, since times on the card move by
up to 20% within one process.  TFLOP/s counts ``4 B Hq T^2 D`` operations,
halved under the causal mask.  The last line is a JSON list of the rows.
Needs a card: without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: the serving path's prefill shape, the same at head dim 128, and one
#: long sequence (the k/v ring wraps 16 times), causal and full
SHAPES = [(4, 1000, 32, 8, 64, True), (4, 1000, 32, 8, 128, True),
          (1, 4096, 32, 8, 64, True), (1, 4096, 32, 8, 64, False),
          (1, 4096, 32, 8, 128, True), (1, 4096, 32, 8, 128, False)]


def times_ms(fn, reps: int, rounds: int):
    """(min, median) ms per call over ``rounds`` batches of ``reps``."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    out.sort()
    return out[0], out[len(out) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, T, Hq, Hkv, D, causal in SHAPES:
        q, k, v = (torch.randn(B, T, h, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: FA.flash_attention_bthd(q, k, v, causal=causal)
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True)
        a = times_ms(kern, args.reps, args.rounds)
        s = times_ms(sdpa, args.reps, args.rounds)
        a2 = times_ms(kern, args.reps, args.rounds)
        flops = 4 * B * Hq * T * T * D / (2 if causal else 1)
        row = dict(shape=[B, T, Hq, Hkv, D], causal=causal,
                   route=FA.route(q.dtype, D), kernel_ms=[*a, *a2],
                   sdpa_ms=list(s),
                   kernel_tflops=flops / min(a[0], a2[0]) / 1e9,
                   sdpa_tflops=flops / s[0] / 1e9)
        rows.append(row)
        print(f"{(B, T, Hq, Hkv, D)} {'causal' if causal else 'full  '} "
              f"{row['route']}: kernel min/median {a[0]:.4f}/{a[1]:.4f}, "
              f"again {a2[0]:.4f}/{a2[1]:.4f} ms "
              f"({row['kernel_tflops']:.0f} TFLOP/s); SDPA {s[0]:.4f}/"
              f"{s[1]:.4f} ms ({row['sdpa_tflops']:.0f} TFLOP/s)")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
