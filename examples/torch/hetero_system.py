"""Heterogeneous (CXL-style) memory system on the port: DDR5 +
CXL-attached DDR4 behind one address mapper (the counterpart of
``examples/hetero_system.py``).

Builds a 2-spec-group system — two native DDR5 channels plus two
CXL-attached DDR4 channels with 80 cycles of link latency each way —
runs it on the card (one fused controller-step launch per spec group and
loop iteration, one host sync per iteration), prints group-correct
metrics, audits the command trace per group, and sweeps the link
latency as a first-class DSE axis.

    PYTHONPATH=src python examples/torch/hetero_system.py [--device cpu]
        [--cycles N] [--sweep-cycles N] [--links 40,80,160,320]
"""
import argparse

from repro_torch import _device
from repro_torch.core import (Simulator, channel_breakdown, compile_system,
                              peak_gbps, throughput_gbps)
from repro_torch.trace import audit, capture


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=20_000)
    ap.add_argument("--sweep-cycles", type=int, default=4_000)
    ap.add_argument("--links", default="40,80,160,320",
                    help="CXL link latencies of the sweep (cycles)")
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    msys = compile_system([
        dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
             timing_preset="DDR5_4800B", channels=2),
        dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
             timing_preset="DDR4_2400R", channels=2, link_latency=80),
    ])
    print(f"memory system: {msys.label} "
          f"({msys.n_channels} channels, {msys.n_groups} spec groups, "
          f"{len(msys.cmd_names)} merged commands)")

    sim = Simulator(system=msys, device=device)
    stats, dense = sim.run(args.cycles, interval=1.0, read_ratio=0.7,
                           trace=True)
    # Stats.summary is group-aware: per-group GB/s on each group's own
    # clock, per-channel rows labeled by the owning standard
    print("\n" + stats.summary(msys))
    assert throughput_gbps(msys, stats) <= peak_gbps(msys)
    assert len(channel_breakdown(msys, stats)) == msys.n_channels

    # per-group audit: each channel replays against its OWN constraint
    # table; DDR5 commands never constrain CXL-DDR4 commands
    tr = capture(msys, dense, controller=sim.controller,
                 frontend=sim.frontend)
    rep = audit(msys, tr)
    print(f"\naudit: {rep.summary()}")
    assert rep.ok

    # link latency as a DSE axis: sweep the CXL link
    from repro_torch.dse import Composition, SweepSpec, execute
    spec = SweepSpec(
        systems=tuple(Composition((("DDR5", 2), ("DDR4", 2, int(link))))
                      for link in args.links.split(",")),
        intervals=(8.0, 2.0), read_ratios=(1.0,),
        n_cycles=args.sweep_cycles)
    res = execute(spec, devices=[device])
    print("\nlink-latency sweep (probe latency is the CXL round trip):")
    print(res.to_table())
    return dict(msys=msys, sim=sim, stats=stats, trace=tr, audit=rep,
                sweep=res)


if __name__ == "__main__":
    main()
