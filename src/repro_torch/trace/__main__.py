"""Trace CLI of the port: ``python -m repro_torch.trace`` — simulate (on
the card unless ``--device cpu``), capture, audit, render.

    # simulate -> capture -> audit -> artifact + HTML
    PYTHONPATH=src python -m repro_torch.trace --standard DDR4 --cycles 20000 \\
        --out trace.npz --html trace.html

    # heterogeneous (CXL-style) composition: repeatable --group
    # STD[:CHANNELS[:LINK_LATENCY]] — per-group zero-violation audit
    PYTHONPATH=src python -m repro_torch.trace --group DDR5:2 --group DDR4:2:80 \\
        --cycles 20000 --fail-on-violations

    # re-audit and re-render a saved artifact
    PYTHONPATH=src python -m repro_torch.trace --load trace.npz --html trace.html

CI uses ``--fail-on-violations`` to turn any audit finding into a nonzero
exit status.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.core.standards import DEFAULT_SYSTEMS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="DRAM command-trace capture, audit, and visualization.")
    src = ap.add_argument_group("trace source")
    src.add_argument("--standard", default="DDR4",
                     help="standard to simulate "
                          f"(known: {','.join(sorted(DEFAULT_SYSTEMS))})")
    src.add_argument("--org", default=None,
                     help="org preset (default: the standard's default)")
    src.add_argument("--timing", default=None,
                     help="timing preset (default: the standard's default)")
    src.add_argument("--cycles", default=20_000, type=int)
    src.add_argument("--channels", default=1, type=int,
                     help="memory-system channel count")
    src.add_argument("--group", default=None, action="append",
                     metavar="STD[:CHANNELS[:LINK]]",
                     help="heterogeneous spec group (repeatable): standard"
                          " name from the default systems, channel count, "
                          "CXL link latency in cycles — e.g. "
                          "--group DDR5:2 --group DDR4:2:80.  Overrides "
                          "--standard/--channels")
    src.add_argument("--mapper", default=None,
                     help="address-mapper order (see repro_torch.core.addrmap."
                          "MAPPERS); default: the frontend's")
    src.add_argument("--interval", default=4.0, type=float,
                     help="streaming inter-arrival interval in cycles")
    src.add_argument("--ratio", default=1.0, type=float, help="read ratio")
    src.add_argument("--scheduler", default="FRFCFS",
                     choices=("FRFCFS", "FCFS"))
    src.add_argument("--seed", default=0x1234, type=int)
    src.add_argument("--device", default=None,
                     help="torch device of the run (default: cuda)")
    src.add_argument("--load", default=None, metavar="TRACE_NPZ",
                     help="audit/render a saved artifact instead of "
                          "simulating")
    out = ap.add_argument_group("outputs")
    out.add_argument("--out", default=None, metavar="TRACE_NPZ",
                     help="write the captured trace artifact here")
    out.add_argument("--html", default=None,
                     help="render the visualizer HTML here")
    out.add_argument("--jsonl", default=None,
                     help="stream the trace as JSON Lines here")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the audit pass")
    ap.add_argument("--fail-on-violations", action="store_true",
                    help="exit nonzero when the audit finds violations")
    ap.add_argument("--max-violations", default=20, type=int,
                    help="violations to print (report stores up to 256)")
    return ap


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


def _simulate_system(args):
    from repro_torch.core import ControllerConfig, Simulator, compile_system
    from repro_torch.trace.capture import capture
    msys = compile_system([_parse_group(g) for g in args.group])
    sim = Simulator(system=msys,
                    controller=ControllerConfig(scheduler=args.scheduler),
                    mapper=args.mapper, device=args.device)
    stats, dense = sim.run(args.cycles, interval=args.interval,
                           read_ratio=args.ratio, trace=True,
                           seed=args.seed)
    trace = capture(
        msys, dense, controller=sim.controller, frontend=sim.frontend,
        n_cycles_requested=args.cycles, interval=args.interval,
        read_ratio=args.ratio, seed=args.seed)
    print(f"simulated {args.cycles} cycles of {msys.label} "
          f"({msys.n_channels} channels, {msys.n_groups} spec groups): "
          f"{len(trace)} commands")
    print(stats.summary(msys))
    return msys, trace


def _simulate(args):
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.trace.capture import capture
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
    sim = Simulator(args.standard, org, tim,
                    controller=ControllerConfig(scheduler=args.scheduler),
                    channels=args.channels, mapper=args.mapper,
                    device=args.device)
    stats, dense = sim.run(args.cycles, interval=args.interval,
                           read_ratio=args.ratio, trace=True,
                           seed=args.seed)
    trace = capture(
        sim.cspec, dense, controller=sim.controller, frontend=sim.frontend,
        n_cycles_requested=args.cycles, interval=args.interval,
        read_ratio=args.ratio, seed=args.seed)
    print(f"simulated {args.cycles} cycles of {args.standard} ({org}/{tim}"
          f", {args.channels} channel{'s' if args.channels > 1 else ''})"
          f": {len(trace)} commands")
    print(stats.summary(sim.cspec))
    return sim.cspec, trace


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch import trace as T

    if args.load:
        trace = T.load(args.load)
        cspec = trace.compiled_system()
        label = cspec.label if "system" in trace.meta \
            else trace.meta["standard"]
        print(f"loaded {args.load}: {len(trace)} commands over "
              f"{trace.n_cycles} cycles of {label} "
              f"(fingerprint {trace.fingerprint})")
    elif args.group:
        cspec, trace = _simulate_system(args)
    else:
        cspec, trace = _simulate(args)

    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        path = T.save(trace, args.out)
        print(f"trace artifact written to {path}")
    if args.jsonl:
        n = T.write_jsonl(trace, args.jsonl)
        print(f"{n} JSONL records written to {args.jsonl}")

    report = None
    if not args.no_audit:
        report = T.audit(cspec, trace)
        print(report.summary())
        for v in report.violations[:args.max_violations]:
            print(f"  {v}")
        if len(report.violations) > args.max_violations:
            print(f"  ... {report.n_violations - args.max_violations} more")

    if args.html:
        d = os.path.dirname(args.html)
        if d:
            os.makedirs(d, exist_ok=True)
        T.write_html(args.html, trace, cspec, report)
        print(f"visualizer written to {args.html}")

    if args.fail_on_violations and report is not None and not report.ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
