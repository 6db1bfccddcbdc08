"""Paper §4 / Fig. 2 on the port: capture a DRAM command trace from a run
on the card, audit it against the timing model, and render the two-view
HTML visualizer (bus utilization + command trace + audit overlay); the
counterpart of ``examples/visualize_trace.py``.

    PYTHONPATH=src python examples/torch/visualize_trace.py [standard]
        [--device cpu] [--cycles N] [--out DIR]
"""
import argparse
import os

from repro_torch import _device
from repro_torch.core import Simulator
from repro_torch.trace import audit, capture, save, write_html

SYSTEMS = {
    "DDR5": ("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),
    "HBM3": ("HBM3", "HBM3_16Gb", "HBM3_5200"),
    "LPDDR5": ("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"),
    "GDDR7": ("GDDR7", "GDDR7_16Gb_x32", "GDDR7_32"),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("standard", nargs="?", default="LPDDR5",
                    choices=sorted(SYSTEMS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=3_000)
    ap.add_argument("--out", default="results/torch")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    std, org, tim = SYSTEMS[args.standard]

    sim = Simulator(std, org, tim, device=device)
    stats, dense = sim.run(args.cycles, interval=2.0, read_ratio=0.75,
                           trace=True)
    trace = capture(sim.cspec, dense, controller=sim.controller,
                    frontend=sim.frontend)
    report = audit(sim.cspec, trace)
    os.makedirs(args.out, exist_ok=True)
    npz = save(trace, os.path.join(args.out, f"{std.lower()}_trace.npz"))
    path = write_html(os.path.join(args.out, f"{std.lower()}_trace.html"),
                      trace, sim.cspec, report,
                      title=f"{std} command trace ({tim})")
    print(f"{len(trace)} commands captured -> {npz}")
    print(report.summary())
    print(f"visualizer -> {path}")
    print("open in a browser: zoom/offset sliders, hover for per-command "
          "info")
    return dict(sim=sim, stats=stats, trace=trace, audit=report, npz=npz,
                html=path)


if __name__ == "__main__":
    main()
