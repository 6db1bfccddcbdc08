"""The workload -> simulator bridge on the port (the counterpart of
``examples/memsys_aware_roofline.py``): estimate the *achieved* HBM
bandwidth of an LM training step's access pattern by running the port's
HBM3 channel model at a streaming, ~2:1 read:write mix on the card (the
fused controller-step kernel), and refine the roofline's memory term of
the dry run's per-device bytes (``python -m repro_torch.launch.dryrun``,
its ``results/dryrun_torch/*train_4k__16x16.json``) with it.  The
bandwidth is the H100's (``repro_torch.launch.mesh.HBM_BW``), not the
reference's TPU v5e figure.

The simulation runs first, whatever the dry run has written (the
reference stops before it when there are no results); with none, the
example says how to make them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
    PYTHONPATH=src python examples/torch/memsys_aware_roofline.py \\
        [--device cpu] [--cycles N] [--results DIR]
"""
import argparse
import glob
import json
import os

from repro_torch import _device
from repro_torch.core import Simulator, peak_gbps, throughput_gbps
from repro_torch.launch.mesh import HBM_BW


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=20_000)
    ap.add_argument("--results", default="results/dryrun_torch",
                    help="the dry run's JSON directory")
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    # HBM3 channel model as the per-device memory system stand-in; a
    # training step's streaming-dominant pattern: high row locality, ~2:1
    # read:write
    sim = Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", device=device)
    stats = sim.run(args.cycles, interval=1.0, read_ratio=0.66)
    achieved = throughput_gbps(sim.cspec, stats) * 1e9
    peak = peak_gbps(sim.cspec) * 1e9
    frac = achieved / peak

    files = sorted(glob.glob(os.path.join(args.results,
                                          "*train_4k__16x16.json")))
    rows = []
    if not files:
        print("no dry-run results: run `PYTHONPATH=src python -m "
              "repro_torch.launch.dryrun --all --mesh 16x16` first")
    else:
        print(f"{'arch':32s} {'bytes/dev':>14} {'naive t_mem':>12} "
              f"{'achieved-BW t_mem':>18}")
    for f in files[:4]:
        with open(f) as fh:
            rec = json.load(fh)
        bytes_dev = rec["cost"]["bytes_accessed"]
        t_naive = bytes_dev / HBM_BW
        t_ach = bytes_dev / (HBM_BW * frac)
        rows.append(dict(arch=rec["arch"], bytes=bytes_dev,
                         t_naive=t_naive, t_achieved=t_ach))
        print(f"{rec['arch']:32s} {bytes_dev:14.3e} {t_naive:12.4f}s "
              f"{t_ach:18.4f}s  (x{t_ach / t_naive:.2f})")
    print("\nachieved/peak from the simulated latency-throughput knee "
          f"= {frac:.3f}")
    return dict(sim=sim, stats=stats, achieved_gbps=achieved / 1e9,
                peak_gbps=peak / 1e9, fraction=frac, rows=rows)


if __name__ == "__main__":
    main()
