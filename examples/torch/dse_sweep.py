"""Design-space exploration with ``repro_torch.dse`` (paper §3.1
workflow, the counterpart of ``examples/dse_sweep.py``): declare a
two-standard x load x read-ratio sweep, execute it on the card (one
cached batched run per standard, every point a lane of the fused
controller-step launch), print the latency-throughput table, persist
the curve artifact, and render a command-trace visualization (paper
§4.1).

    PYTHONPATH=src python examples/torch/dse_sweep.py [--device cpu]
        [--cycles N] [--intervals 32,8,4,2,1] [--read-ratios 1,0.5]
        [--trace-cycles N] [--out DIR]

The same sweep is available as a CLI: ``python -m repro_torch.dse.sweep``.
"""
import argparse
import os

from repro_torch import _device
from repro_torch.core import Simulator
from repro_torch.dse import SweepSpec, execute
from repro_torch.trace import capture, write_html


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=10_000)
    ap.add_argument("--intervals", default="32,8,4,2,1")
    ap.add_argument("--read-ratios", default="1.0,0.5")
    ap.add_argument("--trace-cycles", type=int, default=2_000)
    ap.add_argument("--out", default="results/torch")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    floats = lambda s: tuple(float(x) for x in s.split(","))

    spec = SweepSpec(
        systems=(("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),
                 ("HBM3", "HBM3_16Gb", "HBM3_5200")),
        intervals=floats(args.intervals),
        read_ratios=floats(args.read_ratios),
        n_cycles=args.cycles,
    )
    result = execute(spec, devices=[device])

    print(f"=== {result.meta['n_points']} design points, "
          f"{result.meta['n_groups']} compiled programs, "
          f"{result.meta['wall_s']}s ===")
    print(result.to_table())
    for cv in result.curves():
        print(f"{cv.system:>6} rd={cv.read_ratio:g}: "
              f"peak_frac={cv.peak_fraction:.3f} "
              f"knee@interval={cv.intervals[cv.knee]:g}")
    os.makedirs(args.out, exist_ok=True)
    path = result.save(os.path.join(args.out, "dse_sweep_example"))
    print(f"curve artifact written to {path}")

    # trace visualization of a short saturated window
    sim = Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", device=device)
    stats, dense = sim.run(args.trace_cycles, interval=1.0, read_ratio=0.7,
                           trace=True)
    trace = capture(sim.cspec, dense, controller=sim.controller,
                    frontend=sim.frontend)
    html = write_html(os.path.join(args.out, "hbm3_trace.html"), trace,
                      sim.cspec, title="HBM3 @ saturation (dual C/A)")
    print(f"\ncommand-trace visualizer written to {html}")
    return dict(result=result, sim=sim, stats=stats, trace=trace,
                artifact=path, html=html)


if __name__ == "__main__":
    main()
