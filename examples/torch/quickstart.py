"""Quickstart on the port: the paper's core artifact in PyTorch + CUDA
(the counterpart of ``examples/quickstart.py``).

1. configure a DDR5 system through the auto-generated Python proxies,
2. run a cycle-level simulation (the fused controller-step kernel on
   the card),
3. probe fine-grained timing behavior (Listing-2 API),
4. dump the YAML equivalent of the configuration.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
        [--cycles N]
"""
import argparse

from repro_torch import _device
from repro_torch.core import (DeviceUnderTest, avg_probe_latency_ns,
                              peak_gbps, throughput_gbps)
from repro_torch.core.proxy import PROXIES, System


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--cycles", type=int, default=20_000)
    ap.add_argument("--out", default="results/torch",
                    help="artifact directory (this example writes none)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    # --- 1. configure via proxies (paper §3.1) ----------------------------
    system = System(
        "DDR5", "DDR5_16Gb_x8", "DDR5_4800B",
        controller=PROXIES["Controller"](scheduler="FRFCFS", queue_depth=32),
        frontend=PROXIES["Frontend"](interval=2.0, read_ratio=0.8),
        n_cycles=args.cycles,
    )
    print("=== YAML equivalent (for non-Python embedders) ===")
    print(system.to_yaml())

    # --- 2. simulate ------------------------------------------------------
    # Stats.summary(spec) is the group-aware formatter (GB/s vs peak, probe
    # latency in ns, row-hit rate); the raw helpers take the Stats of ONE
    # run
    sim = system.build(device=device)
    stats = sim.run(system.n_cycles)
    print("\n=== simulation ===")
    print(stats.summary(sim.cspec))
    assert throughput_gbps(sim.cspec, stats) <= peak_gbps(sim.cspec)
    assert avg_probe_latency_ns(sim.cspec, stats) > 0

    # --- 3. fine-grained probing (paper Listing 2) ------------------------
    # the probe API is the scalar host oracle: it never touches the card
    dut = DeviceUnderTest("DDR5", org_preset="DDR5_16Gb_x8",
                          timing_preset="DDR5_4800B")
    addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)
    probes = {"closed": dut.probe("RD", addr, clk=0)}
    print("\n=== probe API ===")
    print("RD on closed bank:", probes["closed"])
    dut.issue("ACT", addr, clk=0)
    probes["before_nRCD"] = dut.probe("RD", addr,
                                      clk=dut.timings["nRCD"] - 1)
    probes["at_nRCD"] = dut.probe("RD", addr, clk=dut.timings["nRCD"])
    print("RD before nRCD:  ", probes["before_nRCD"])
    print("RD at nRCD:      ", probes["at_nRCD"])
    return dict(system=system, sim=sim, stats=stats, probes=probes)


if __name__ == "__main__":
    main()
