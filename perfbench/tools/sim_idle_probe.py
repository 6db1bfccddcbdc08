#!/usr/bin/env python3
"""How far the host paces the simulator's sweep loop on the card.

    python3 perfbench/tools/sim_idle_probe.py [--points 64,256,1024] [--cycles 5000]

A diagnostic, not a cell: ``dse.execute`` over one DDR5 system
(DDR5_16Gb_x8, DDR5_4800B, 8 channels, FR-FCFS) with a square grid of
load points (intervals 1-8 x read ratios 0.5-1.0), each size run once to
build its cached run and once under ``torch.profiler``.  Prints, per
size, one JSON line: the traced wall, the device's busy and idle share of
it, loop iterations (launches of the fused controller-step kernel, one an
iteration) and ms per iteration.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", default="64,256,1024")
    ap.add_argument("--cycles", type=int, default=5000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import numpy as np
    import torch
    from repro_torch.dse import executor
    from repro_torch.dse.spec import SweepSpec, System
    from yardstick import trace as tr
    if not torch.cuda.is_available():
        print("sim_idle_probe: needs a CUDA card", file=sys.stderr)
        return 3
    for p in (int(x) for x in args.points.split(",")):
        side = int(math.isqrt(p))
        spec = SweepSpec(
            systems=(System("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),),
            intervals=tuple(np.linspace(1.0, 8.0, side)),
            read_ratios=tuple(np.linspace(0.5, 1.0, side)),
            channels=(8,), n_cycles=args.cycles)
        t0 = time.perf_counter()
        executor.execute(spec)
        first = time.perf_counter() - t0
        torch.cuda.synchronize()
        with tr.profiler() as prof:
            with tr.window_span():
                executor.execute(spec)
                torch.cuda.synchronize()
        t = tr.reduce(prof, {}, None)
        iters = len(t.kernels(lambda n: "controller_step_kernel" in n))
        print(json.dumps({
            "points": side * side, "channels": 8, "cycles": args.cycles,
            "first_call_s": first, "traced_s": t.window_s,
            "busy_s": t.busy_s, "idle_share": 1 - t.busy_s / t.window_s,
            "iterations": iters,
            "ms_per_iteration": 1e3 * t.window_s / iters if iters else None,
            "breakdown": t.breakdown(5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
