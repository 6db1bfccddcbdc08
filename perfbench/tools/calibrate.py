#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed it builds the program's state as a run does, takes the
program's readings without a measured window (training: the set-up
steps; prefill: the requests up to the last checked one) and compares them
with the reference: the lower readings.  For each control seed it also
puts the reference computed in float8 in the program's place (the
control) and reads the planted faults the cell can have: training's half
batch (the mean over the other half) and prefill's altered token.  A
state left unchanged reads 1 by the training measure and needs no run.
One JSON object a reading, on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def train_readings(ctx, control: bool) -> list:
    import torch
    from yardstick import compare
    drv = _driver("train")
    state, step, prog = drv.setup(ctx)
    del state, step
    torch.cuda.empty_cache() if ctx.device.type == "cuda" else None
    ref = drv.reference(ctx)
    out = [("program", compare.train_numbers(prog, ref))]
    if control:
        out.append(("control_fp8", compare.train_numbers(
            drv.reference(ctx, "fp8"), ref)))
        half = ctx.cell.traffic["batch"] // 2
        out.append(("fault_half_batch", compare.train_numbers(
            drv.reference(ctx, rows=half), ref)))
    return out


def prefill_readings(ctx, control: bool) -> list:
    import torch
    drv = _driver("prefill")
    serve, signs = drv.setup(ctx)
    want = drv.picks(ctx)
    served, kept = [], {}
    for n in range(max(want) + 1):
        drv.serve_one(serve, n, want, served, kept, signs)
    del serve
    torch.cuda.empty_cache() if ctx.device.type == "cuda" else None
    return list(drv.check(ctx, served, kept, control).items())


def _driver(name: str):
    from run import load_module
    return load_module(HERE / "drivers" / f"{name}.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import run as bench_run
    bench_run.environment()
    import torch
    from yardstick.harness import Cell, Run
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell.load(bench, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    read = train_readings if cell.traffic["driver"] == "train" \
        else prefill_readings
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            ctx = Run(cell=cell, seed=seed, seconds=0.0, traced=False,
                      device=torch.device("cuda", 0), t_start=t0)
            for what, numbers in read(ctx, seed in controls):
                line = json.dumps({"cell": cell.name, "seed": seed,
                                   "what": what, "numbers": numbers,
                                   "s": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
