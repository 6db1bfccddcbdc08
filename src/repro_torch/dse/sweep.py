"""Sweep CLI: ``python -m repro_torch.dse.sweep`` (the reference's flags,
plus ``--device``).

Runs a multi-standard latency-throughput sweep in one invocation — each
(system, controller) pair is one cached run whose design points are its
whole load grid, on the card — prints the table plus the run-cache
accounting, and persists the curve artifact (`.npz` + `.json`, the
reference's format) for downstream benchmarks and plots.

    PYTHONPATH=src python -m repro_torch.dse.sweep
    PYTHONPATH=src python -m repro_torch.dse.sweep --standards DDR4,HBM3 \
        --intervals 16,4,1 --cycles 2000 --out build/dse_smoke
    PYTHONPATH=src python -m repro_torch.dse.sweep --device cpu \
        --standards DDR4 --intervals 8,1 --cycles 500
"""
from __future__ import annotations

import argparse

from repro_torch.dse.executor import execute
from repro_torch.dse.results import SweepResult
from repro_torch.dse.spec import DEFAULT_SYSTEMS, SweepSpec


def _floats(csv: str) -> tuple:
    return tuple(float(x) for x in csv.split(",") if x)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.sweep",
        description="Multi-standard DRAM latency-throughput sweep "
                    "(one cached batched run per system, on the card).")
    ap.add_argument("--standards", default="DDR5,HBM3",
                    help="comma-separated standard names "
                         f"(known: {','.join(sorted(DEFAULT_SYSTEMS))})")
    ap.add_argument("--intervals", default="64,16,8,4,2,1", type=_floats,
                    help="streaming inter-arrival intervals in cycles, "
                         "high interval = low load")
    ap.add_argument("--ratios", default="1.0", type=_floats,
                    help="read ratios in [0,1]")
    ap.add_argument("--channels", default="1",
                    help="comma-separated memory-system channel counts")
    ap.add_argument("--mappers", default=None,
                    help="comma-separated address-mapper orders "
                         "(see repro_torch.core.addrmap.MAPPERS)")
    ap.add_argument("--cycles", default=10_000, type=int,
                    help="simulated cycles per point")
    ap.add_argument("--scheduler", default="FRFCFS",
                    choices=("FRFCFS", "FCFS"))
    ap.add_argument("--out", default="results/dse_sweep",
                    help="artifact basename (writes <out>.npz + <out>.json)")
    ap.add_argument("--seed", default=0x1234, type=int)
    ap.add_argument("--telemetry", default=0, type=int, metavar="W",
                    help="windowed-telemetry window in cycles (0 = off); "
                         "every point gains a Telemetry time series")
    ap.add_argument("--telemetry-dir", default=None,
                    help="persist one telemetry .npz per point here "
                         "(needs --telemetry)")
    ap.add_argument("--device", default="cuda",
                    help="the run's device: cuda (the card) or cpu")
    return ap


def main(argv=None) -> SweepResult:
    args = build_parser().parse_args(argv)
    from repro_torch.core import ControllerConfig
    spec = SweepSpec(
        systems=tuple(s.strip() for s in args.standards.split(",") if s),
        intervals=args.intervals, read_ratios=args.ratios,
        controllers=(ControllerConfig(scheduler=args.scheduler),),
        channels=tuple(int(c) for c in args.channels.split(",") if c),
        mappers=(tuple(m.strip() for m in args.mappers.split(",") if m)
                 if args.mappers else None),
        n_cycles=args.cycles, seed=args.seed,
        telemetry=args.telemetry, telemetry_dir=args.telemetry_dir)
    print(f"expanding {spec.grid_shape} grid -> {spec.n_points} points")
    result = execute(spec, devices=[args.device])
    print(result.to_table())
    m = result.meta
    c = m["cache"]
    print(f"\n{m['n_groups']} compiled programs for {m['n_points']} points "
          f"({m['compile_cache_misses']} compiles, "
          f"{m['compile_cache_hits']} cache hits, {m['traces']} traces) "
          f"in {m['wall_s']}s on {m['n_devices']} device(s) "
          f"({m['device']}; {m['host_syncs']} loop iterations)")
    print(f"run cache: {c['entries']} live programs, {c['hits']} hits / "
          f"{c['misses']} misses, first-call (trace+compile+run) "
          f"{c['first_call_s']}s; topologies: "
          f"{', '.join(c.get('shard_topologies', ())) or 'none'}")
    spans = m.get("profile", {}).get("spans", {})
    if spans:
        attribution = ", ".join(
            f"{name} {s['s']}s x{s['calls']}"
            for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["s"]))
        print(f"streamed pipeline (max {m['max_in_flight']} in flight): "
              f"{attribution}")
    if m.get("padded_points"):
        print(f"batch padding: {m['padded_points']} repeated point(s) "
              f"simulated for device alignment and dropped")
    if result.telemetry:
        n_art = len(m.get("telemetry_artifacts", []))
        print(f"telemetry: {len(result.telemetry)} per-point series "
              f"(window={spec.telemetry})"
              + (f", {n_art} artifacts in {spec.telemetry_dir}"
                 if n_art else ""))
    for cv in result.curves():
        knee_iv = cv.intervals[cv.knee]
        print(f"  {cv.system:>10} rd={cv.read_ratio:g}: "
              f"peak_frac={cv.peak_fraction:.3f} "
              f"knee@interval={knee_iv:g} "
              f"({cv.latency_ns[cv.knee]:.1f} ns)")
    path = result.save(args.out)
    print(f"curve artifact written to {path} (+ .json)")
    return result


if __name__ == "__main__":
    main()
