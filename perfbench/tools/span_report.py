#!/usr/bin/env python3
"""Where a traced window's time goes, by the program's own spans.

    python3 perfbench/tools/span_report.py --workload <cell> --seed <n> --seconds <s> [--out <file.json>]

A diagnostic, not a cell: runs the cell as ``run.py --trace 1`` does and
prints its result line, then one JSON object: for each span the program
recorded (``repro_torch.telemetry.spans``), its count, its count and
device milliseconds a step or request, its summed ``device_s`` as a share
of the window and of the device's busy time, and its allocator deltas;
the coverage of the outermost spans; and the longest idle gaps, each with
what the host was doing and the program span open around it, with that
span's allocator deltas.  Exits 3 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
ALLOC = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def by_name(t, recs: list, units: int) -> dict:
    out = {}
    for r in recs:
        o = out.setdefault(r["name"], {"count": 0, "device_s": 0.0,
                                       **dict.fromkeys(ALLOC, 0)})
        o["count"] += 1
        o["device_s"] += r["device_s"]
        for k in ALLOC:
            o[k] += r[k]
    for o in out.values():
        o["per_unit"] = o["count"] / units
        o["ms_per_unit"] = 1e3 * o["device_s"] / units
        o["window_pct"] = 100.0 * o["device_s"] / t.window_s
        o["busy_pct"] = 100.0 * o["device_s"] / t.busy_s
    return out


def span_at(t, recs: list, at: int):
    """The innermost program span whose host range holds ``at``, as its
    record (the k-th host range of a name is the k-th record of it)."""
    names = {r["name"] for r in recs}
    seen: dict = {}
    best = None
    for name, s, e in t.host:
        if name not in names:
            continue
        k = seen[name] = seen.get(name, -1) + 1
        if s > at:
            break
        if e >= at:
            best = (name, k)
    if best is None:
        return None
    return [r for r in recs if r["name"] == best[0]][best[1]]


def gaps(t, recs: list, n: int = 10) -> list:
    out = []
    for s, e in sorted(t.idle_gaps(), key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) // 2
        r = span_at(t, recs, mid)
        out.append({"ms": (e - s) / 1e6, "host": t.host_doing(mid),
                    "span": r and {k: r[k] for k in (
                        "name", "step", "request", "group", "layer", "chunk",
                        *ALLOC)}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import time
    t_start = time.perf_counter()
    import run
    run.environment()
    import torch
    import program_spans
    from yardstick import spans
    from yardstick.harness import Cell, Run
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell.load(bench, args.workload)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    ctx = Run(cell=cell, seed=args.seed, seconds=args.seconds, traced=True,
              device=dev, t_start=t_start)
    driver = run.load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    res = driver.run(ctx)
    print(json.dumps(run.report(bench, ctx, res, kind, run.power_limit())),
          flush=True)
    t = ctx.trace
    recs = program_spans.records(t)
    units = res["info"].get("steps") or res["info"].get("requests") or 1
    top = [r["name"] for r in recs if r["parent"] is None]
    rep = {"cell": cell.name, "seed": args.seed, "device": kind,
           "window_s": t.window_s, "busy_s": t.busy_s, "units": units,
           "spans": by_name(t, recs, units),
           "coverage_busy_pct": spans.busy_share(t, recs, set(top)),
           "coverage_window_pct": spans.window_share(t, recs, set(top)),
           "gaps": gaps(t, recs)}
    print(json.dumps(rep), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
