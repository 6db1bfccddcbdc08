#!/usr/bin/env python3
"""Profile the PyTorch port's cycle loop on one device.

    PYTHONPATH=src python tools/profile_torch_step.py [--device cuda]
        [--standard DDR5] [--cycles 3000] [--interval 2.0] [--read-ratio 0.8]
        [--channels 1] [--points 1] [--user-predicate] [--telemetry W]
        [--replay]

With ``--points 1`` it profiles one ``Simulator.run`` at ``--interval``
and ``--read-ratio``; with ``--points P > 1`` one ``Simulator.run_batch``
of the first ``P`` load points of the batched session (intervals [1, 1.5,
2, 3, 4, 6, 8, 16] x read ratios [1.0, 0.8, 0.6, 0.5], in that order: the
first ``P / 4`` intervals with every ratio, or interval 1 with the first
``P`` ratios for ``P <= 4``).  A
"step" below is one loop iteration: one executed cycle of every point
still running, one fused launch over all ``P * channels`` lanes.  With
``--user-predicate`` the controller takes the user predicate of
``tests/core/test_controllers.py`` (no write ever issues), whose mask the
cycle computes on the device before each launch.  With ``--telemetry W``
(one point only) every run folds the windowed-telemetry gauges and takes
a snapshot at each multiple of ``W``.  With ``--replay`` the simulator
replays a stream instead of its synthetic one: a 4,000-cycle source run
of the same system (interval 4.0, read ratio 0.5) captured on the device
and turned into a paced stream with dependencies
(``trace.to_replay(deps=True)``), replayed with
``FrontendConfig(pattern="trace", probes=False)``.

Prints (after a short warm-up run): wall seconds, loop iterations,
milliseconds per iteration, host syncs, fused controller-step launches and
plain-step calls; then a ``torch.profiler`` table of a short window (300
cycles) with the device time by kernel, and a JSON summary as the last
line: ``ms_per_step``, ``fused_launches_per_step`` (the fused kernel's
launches per iteration), ``device_ms_per_step`` (summed kernel and copy
time per iteration), ``fused_device_us`` (the fused kernel's device time
per launch), ``dtoh_copies_per_step`` (device-to-host copies: each is a
host wait), ``device_launches_per_step``, ``device_busy_share`` (device
time per iteration over the unprofiled wall time per iteration: the
profiler slows the host, not the device; these five are ``null`` when the
profiler reports no device work), ``ops_per_step`` (top-level operator
calls per iteration) and ``point_cycles_per_s``.  On a CUDA device it
synchronizes before reading every clock.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.standards import DEFAULT_SYSTEMS  # noqa: E402

#: the batched session's load points (``tests/torch_batch_stats.json``)
INTERVALS = [1, 1.5, 2, 3, 4, 6, 8, 16]
READ_RATIOS = [1.0, 0.8, 0.6, 0.5]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--standard", default="DDR5",
                    choices=sorted(DEFAULT_SYSTEMS))
    ap.add_argument("--cycles", type=int, default=3000)
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--read-ratio", type=float, default=0.8)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--points", type=int, default=1,
                    choices=[1, 2, 3, 4, 8, 12, 16, 20, 24, 28, 32])
    ap.add_argument("--user-predicate", action="store_true")
    ap.add_argument("--telemetry", type=int, default=0, metavar="W")
    ap.add_argument("--replay", action="store_true")
    args = ap.parse_args()
    if args.telemetry and args.points != 1:
        ap.error("--telemetry profiles one point (--points 1)")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ControllerConfig, FrontendConfig, Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import capture, to_replay

    cuda = torch.device(args.device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    org, tim = DEFAULT_SYSTEMS[args.standard]
    preds = ((lambda cspec, ctx: ctx.cand_cmd != cspec.id_WR,)
             if args.user_predicate else ())
    sim = Simulator(args.standard, org, tim, channels=args.channels,
                    device=args.device,
                    controller=ControllerConfig(extra_predicates=preds))
    if args.replay:
        _, dense = sim.run(4000, interval=4.0, read_ratio=0.5, trace=True)
        stream = to_replay(capture(sim.cspec, dense), sim.cspec, deps=True)
        sim = Simulator(args.standard, org, tim, channels=args.channels,
                        device=args.device, controller=sim.controller,
                        frontend=FrontendConfig(pattern="trace",
                                                probes=False),
                        replay=stream)
    n_rr = min(args.points, len(READ_RATIOS))
    intervals = INTERVALS[:args.points // n_rr]
    read_ratios = READ_RATIOS[:n_rr]

    def run(n):
        """One run of ``n`` cycles; its loop iterations (host syncs) and
        its executed point-cycles."""
        before = sim.host_syncs
        if args.points == 1:
            st = sim.run(n, interval=args.interval,
                         read_ratio=args.read_ratio,
                         telemetry=args.telemetry)
            if args.telemetry:
                st = st[0]
            return sim.host_syncs - before, st.scan_steps
        _, st = sim.run_batch(n, intervals, read_ratios)
        return sim.host_syncs - before, int(sum(st.scan_steps))

    run(200)
    sync()
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    steps, executed = run(args.cycles)
    sync()
    wall = time.perf_counter() - t0
    print(f"{args.standard} x {args.channels} channels, {args.points} "
          f"points, {args.cycles} cycles on {args.device}"
          + (f", telemetry={args.telemetry}" if args.telemetry else "")
          + (", replay" if args.replay else "") + ": wall "
          f"{wall:.3f} s, loop iterations {steps}, executed point-cycles "
          f"{executed}, {wall / steps * 1e3:.3f} ms/iteration, host syncs "
          f"{steps}, fused controller-step launches {KS.launch_count}, "
          f"plain steps {C.plain_calls}")
    fused_per_step = KS.launch_count / steps

    window = 300
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        win_steps, _ = run(window)
        sync()
    ka = prof.key_averages()
    # top-level operator calls only (nested aten calls are not dispatches
    # of their own); device rows are the kernels and copies themselves
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / win_steps
    dtoh = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
    fused = [e for e in dev if "controller_step_kernel" in e.key]
    fused_us = (sum(e.self_device_time_total for e in fused)
                / sum(e.count for e in fused)) if fused else None
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    print(ka.table(sort_by=sort, row_limit=15))
    print(json.dumps({
        "standard": args.standard, "channels": args.channels,
        "points": args.points, "user_predicate": args.user_predicate,
        "telemetry": args.telemetry, "replay": args.replay,
        "device": args.device,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cycles": args.cycles, "steps": steps, "wall_s": wall,
        "ms_per_step": wall / steps * 1e3,
        "fused_launches_per_step": fused_per_step,
        "fused_device_us": fused_us,
        "dtoh_copies_per_step": dtoh / win_steps if dev else None,
        "device_ms_per_step": dev_ms if dev else None,
        "device_launches_per_step": (sum(e.count for e in dev)
                                     / win_steps if dev else None),
        "device_busy_share": (dev_ms / (wall / steps * 1e3)
                              if dev else None),
        "ops_per_step": n_ops / win_steps,
        "point_cycles_per_s": args.points * args.cycles / wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
