"""Multi-channel memory system on the port (the counterpart of
``examples/multichannel.py``).

Builds a 4-channel HBM3 system, runs it under load on the card (every
channel a lane of one fused controller-step launch per loop iteration),
prints per-channel and aggregate stats, captures a trace, audits it per
channel, and then drives a 2-channel DDR4 system with the trace-driven
frontend (replaying a synthetic linear-address stream decoded through
the 2-channel mapper).

    PYTHONPATH=src python examples/torch/multichannel.py [--device cpu]
        [--cycles N] [--requests N]
"""
import argparse

import numpy as np

from repro_torch import _device
from repro_torch.core import (FrontendConfig, ReplayStream, Simulator,
                              channel_breakdown, peak_gbps, throughput_gbps)
from repro_torch.trace import audit, capture, to_replay


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=10_000)
    ap.add_argument("--requests", type=int, default=8_000,
                    help="length of the replayed address stream")
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    # -- 4-channel HBM3: per-channel + aggregate stats ---------------------
    quad = Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", channels=4,
                     mapper="RoBaRaCoCh", device=device)
    stats, dense = quad.run(args.cycles, interval=0.5, read_ratio=0.9,
                            trace=True)
    print(f"aggregate: {throughput_gbps(quad.cspec, stats):.1f} GB/s of "
          f"{peak_gbps(quad.cspec):.1f} peak "
          f"({int(stats.reads_done)} reads, {int(stats.writes_done)} writes)")
    for c, row in channel_breakdown(quad.cspec, stats).items():
        print(f"  ch{c}: {row['throughput_gbps']:6.1f} GB/s  "
              f"bus util {row['bus_util']:.2f}")

    # -- per-channel audit --------------------------------------------------
    trace = capture(quad.cspec, dense, controller=quad.controller,
                    frontend=quad.frontend)
    report = audit(quad.cspec, trace)
    print(report.summary())

    # a capture replays directly on the SAME channel layout:
    same_system_replay = to_replay(trace, quad.cspec)
    print(f"derived {len(same_system_replay)}-request replay stream from "
          "the capture")

    # -- trace-driven frontend on a different system -----------------------
    # For a different channel count, decode a linear-address stream through
    # the target system's own mapper instead of reusing captured channels.
    ddr = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    device=device)
    rng = np.random.default_rng(0)
    addrs = rng.integers(0, 1 << 28, args.requests).astype(np.int64) \
        * ddr.cspec.access_bytes
    rs = ReplayStream.from_addresses(ddr.cspec, addrs,
                                     is_write=rng.random(args.requests) < 0.3)
    ddr_replay = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                           frontend=FrontendConfig(pattern="trace",
                                                   probes=False),
                           replay=rs, device=device)
    st = ddr_replay.run(args.cycles, interval=1.0)
    print(f"replayed {int(st.reads_done)} reads / {int(st.writes_done)} "
          f"writes onto 2-channel DDR4; per-channel reads: "
          f"{st.per_channel.reads_done.tolist()}")
    return dict(quad=quad, stats=stats, trace=trace, audit=report,
                replay=same_system_replay, ddr_replay=ddr_replay,
                replay_stats=st)


if __name__ == "__main__":
    main()
