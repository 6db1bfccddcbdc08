"""Telemetry CLI of the port: ``python -m repro_torch.telemetry`` —
simulate with windowed metrics (on the card unless ``--device cpu``),
verify, profile, export.

    # windowed metrics + timeline HTML + artifacts
    PYTHONPATH=src python -m repro_torch.telemetry --standard HBM3 --channels 2 \\
        --cycles 20000 --window 256 --out telem.npz --html telem.html

    # heterogeneous (CXL-style) composition, bit-consistency check
    PYTHONPATH=src python -m repro_torch.telemetry --group DDR5:2 --group \\
        DDR4:2:80 --cycles 20000 --check

    # host-side profile (first call vs warm cost, cycles/sec)
    PYTHONPATH=src python -m repro_torch.telemetry --standard DDR4 --profile

CI uses ``--check`` to turn any window/aggregate mismatch into a nonzero
exit status.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.core.standards import DEFAULT_SYSTEMS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Windowed telemetry capture, verification, profiling, "
                    "and timeline rendering.")
    src = ap.add_argument_group("run")
    src.add_argument("--standard", default="DDR4",
                     help="standard to simulate "
                          f"(known: {','.join(sorted(DEFAULT_SYSTEMS))})")
    src.add_argument("--org", default=None)
    src.add_argument("--timing", default=None)
    src.add_argument("--cycles", default=20_000, type=int)
    src.add_argument("--channels", default=1, type=int)
    src.add_argument("--group", default=None, action="append",
                     metavar="STD[:CHANNELS[:LINK]]",
                     help="heterogeneous spec group (repeatable), e.g. "
                          "--group DDR5:2 --group DDR4:2:80; overrides "
                          "--standard/--channels")
    src.add_argument("--mapper", default=None)
    src.add_argument("--interval", default=4.0, type=float)
    src.add_argument("--ratio", default=1.0, type=float)
    src.add_argument("--scheduler", default="FRFCFS",
                     choices=("FRFCFS", "FCFS"))
    src.add_argument("--seed", default=0x1234, type=int)
    src.add_argument("--window", default=256, type=int,
                     help="telemetry window in cycles")
    src.add_argument("--device", default=None,
                     help="torch device of the run (default: cuda)")
    src.add_argument("--load", default=None, metavar="TELEM_NPZ",
                     help="render/export a saved artifact instead of "
                          "simulating")
    out = ap.add_argument_group("outputs")
    out.add_argument("--out", default=None, metavar="TELEM_NPZ")
    out.add_argument("--jsonl", default=None)
    out.add_argument("--html", default=None)
    ap.add_argument("--check", action="store_true",
                    help="verify sum-over-windows == Stats aggregates; "
                         "exit nonzero on any mismatch")
    ap.add_argument("--profile", action="store_true",
                    help="also print the host-side run profile "
                         "(compile vs warm cost, cycles/sec)")
    return ap


def _make_sim(args):
    from repro_torch.core import ControllerConfig, Simulator, compile_system
    if args.group:
        msys = compile_system([_parse_group(g) for g in args.group])
        return Simulator(system=msys, mapper=args.mapper,
                         controller=ControllerConfig(
                             scheduler=args.scheduler), device=args.device)
    if args.org is None or args.timing is None:
        if args.standard not in DEFAULT_SYSTEMS:
            raise SystemExit(
                f"no default org/timing for {args.standard!r}; pass --org "
                f"and --timing (known defaults: {sorted(DEFAULT_SYSTEMS)})")
        org, tim = DEFAULT_SYSTEMS[args.standard]
        org = args.org or org
        tim = args.timing or tim
    else:
        org, tim = args.org, args.timing
    return Simulator(args.standard, org, tim, channels=args.channels,
                     mapper=args.mapper,
                     controller=ControllerConfig(scheduler=args.scheduler),
                     device=args.device)


def _parse_group(text: str) -> dict:
    parts = text.split(":")
    std = parts[0]
    if std not in DEFAULT_SYSTEMS:
        raise SystemExit(f"no default org/timing for {std!r}; known: "
                         f"{sorted(DEFAULT_SYSTEMS)}")
    org, tim = DEFAULT_SYSTEMS[std]
    return dict(standard=std, org_preset=org, timing_preset=tim,
                channels=int(parts[1]) if len(parts) > 1 else 1,
                link_latency=int(parts[2]) if len(parts) > 2 else 0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch import telemetry as T

    stats = None
    if args.load:
        telem = T.load(args.load)
        print(f"loaded {args.load}: {telem.n_windows} windows of "
              f"{telem.window} cycles ({telem.meta.get('label', '?')})")
    else:
        if args.window <= 0:
            raise SystemExit("--window must be a positive cycle count")
        sim = _make_sim(args)
        stats, telem = sim.run(args.cycles, interval=args.interval,
                               read_ratio=args.ratio, seed=args.seed,
                               telemetry=args.window)
        print(f"simulated {args.cycles} cycles of {sim.msys.label} "
              f"(window={args.window})")
        print(stats.summary(sim.msys))

    print(telem.summary())

    if args.check:
        if stats is None:
            raise SystemExit("--check needs a fresh run, not --load")
        try:
            telem.check(stats)
        except ValueError as e:
            print(e)
            return 1
        print("check: sum-over-windows == Stats aggregates "
              f"({telem.n_windows} windows, ragged tail "
              f"{'yes' if args.cycles % args.window else 'no'})")

    if args.profile:
        if args.load:
            raise SystemExit("--profile needs a fresh run, not --load")
        p = T.profile_run(sim, args.cycles, interval=args.interval,
                          read_ratio=args.ratio, telemetry=args.window)
        print(f"profile: first call {p['first_call_s']}s "
              f"(compile ~{p['compile_s']}s), warm {p['warm_s']}s = "
              f"{p['cycles_per_sec']:,.0f} cycles/s; cache {p['cache']}")

    for path, writer, what in ((args.out, T.save, "telemetry artifact"),
                               (args.jsonl, lambda t, p: T.write_jsonl(t, p),
                                "JSONL records"),
                               (args.html, lambda t, p: T.write_html(p, t),
                                "timeline")):
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            writer(telem, path)
            print(f"{what} written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
