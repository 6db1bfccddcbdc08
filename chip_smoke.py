#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on any mismatch or exception:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path with ``nvcc`` into
   ``build/kernels/`` (all sources compiled in parallel);
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit, on random device histories of every default system (timestamps
   below and above 2**24), and time kernel and plain version with CUDA
   events at the main path's shapes;
4. reproduce the 11 single-spec golden command-stream hashes of
   ``tests/trace/golden_hashes.json`` on ``cuda`` (3000 cycles, interval
   2.0, read ratio 0.7, FR-FCFS, fast-forward on), each run launching the
   readiness kernel; the runs share the card from worker processes, one
   per spare CPU core, since each is bound by its host loop;
5. run the README's session — DDR5_16Gb_x8 / DDR5_4800B, 20,000 cycles,
   interval 2.0, read ratio 0.8 — with every launch count set to 0 just
   before and read just after, and require its ``Stats`` to equal the
   reference fixture ``tests/torch_main_path_stats.json`` exactly.

The line before the last is a JSON object with one entry per kernel (its
times, bound and launches); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(standard="DDR5", org="DDR5_16Gb_x8", timing="DDR5_4800B",
            n_cycles=20_000, interval=2.0, read_ratio=0.8, seed=0x1234)

#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core fp32 rate
#: (integer add/compare/max issue on the same CUDA cores)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed
    with CUDA events after a warm-up."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, kernel: str, reps: int = 200):
    """Mean device time in µs of the kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``;
    None when the profiler reports no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "self_device_time_total", 0) or 0 for e in hits)
    count = sum(e.count for e in hits)
    return total / count if total and count else None


def random_state(cspec, dp, device, seed: int, clk0: int, steps: int = 80):
    """A device state after ``steps`` random commands at random
    addresses and increasing clocks, applied with the port's ``issue``."""
    import numpy as np
    import torch
    from repro_torch.core import device as D
    rng = np.random.default_rng(seed)
    state = D.init_state(cspec, 1, device)
    clk = clk0
    counts = [int(c) for c in cspec.level_counts[1:]]
    for _ in range(steps):
        cmd = torch.tensor([int(rng.integers(cspec.n_cmds))],
                           dtype=torch.int32, device=device)
        sub = torch.tensor([[int(rng.integers(c)) for c in counts]],
                           dtype=torch.int32, device=device)
        row = torch.tensor([int(rng.integers(64))], dtype=torch.int32,
                           device=device)
        on = torch.ones(1, dtype=torch.bool, device=device)
        state = D.issue(cspec, dp, state, cmd, sub, row, clk, on)
        clk += int(rng.integers(1, 8))
    return state


def kernel_phase(device):
    """Kernel vs plain version on every default system; timings at the
    main path's (DDR5, one channel) shapes."""
    import torch
    from repro_torch.core import compile_spec
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import readiness as R
    max_err, rows = 0, []
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device)
        tab = dp.tables.ready
        for j, clk0 in enumerate((0, (1 << 24) + 12345)):
            st = random_state(cspec, dp, device, seed=100 * i + j, clk0=clk0)
            got = R.readiness_table_cuda(tab, st.last_issue, st.win_ring)
            want = R.readiness_table_plain(tab, st.last_issue, st.win_ring)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if err or got.shape != want.shape:
                fail(f"readiness kernel != plain version on {std} "
                     f"(clk0={clk0}): max |diff| {err}")
        kern_ms = cuda_ms(lambda: R.readiness_table_cuda(
            tab, st.last_issue, st.win_ring), 2000)
        plain_ms = cuda_ms(lambda: R.readiness_table_plain(
            tab, st.last_issue, st.win_ring), 500)
        dev_us = device_us(lambda: R.readiness_table_cuda(
            tab, st.last_issue, st.win_ring), "readiness_table_kernel")
        K = tab.A.shape[0]
        nbytes = 4 * (st.last_issue.numel() + st.win_ring.numel()
                      + tab.keys.numel() + tab.A.numel()
                      + cspec.n_cmds * cspec.n_banks)
        # per (cmd, bank) cell and key with a constraint: compare, add, max
        ops = 3 * int(tab.present.sum()) * cspec.n_banks
        rows.append(dict(std=std, kernel_ms=kern_ms, plain_ms=plain_ms,
                         device_us=dev_us, bytes=nbytes, ops=ops, keys=K,
                         cells=cspec.n_cmds * cspec.n_banks,
                         bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         ops_ms=ops / CUDA_CORE_OPS_PER_S * 1e3))
    print("readiness kernel vs plain version (bit-exact on all systems, "
          "max |diff| 0); per launch, one channel:")
    print("  (kernel_us and plain_us: back-to-back calls timed with CUDA "
          "events; device_us: the kernel alone, torch.profiler)")
    print(f"  {'standard':<9} {'keys':>4} {'cells':>5} {'kernel_us':>10} "
          f"{'device_us':>9} {'plain_us':>9} {'bound_ns':>9}")
    for r in rows:
        dev = ("not measured" if r["device_us"] is None
               else f"{r['device_us']:.3f}")
        print(f"  {r['std']:<9} {r['keys']:>4} {r['cells']:>5} "
              f"{r['kernel_ms'] * 1e3:>10.2f} {dev:>9} "
              f"{r['plain_ms'] * 1e3:>9.2f} "
              f"{max(r['bytes_ms'], r['ops_ms']) * 1e6:>9.3f}")
    return max_err, {r["std"]: r for r in rows}


def golden_run(std: str, org: str, tim: str, device: str) -> dict:
    """One run of the port at the golden configuration (run in a worker
    process): its command count and digest, executed steps, wall seconds
    and readiness-kernel launches."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.kernels import readiness as R
    from repro_torch.trace import capture, trace_sha256
    sim = Simulator(std, org, tim, device=device,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    R.launch_count = 0
    t0 = time.perf_counter()
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = capture(sim.cspec, dense)
    return dict(n=len(tr), sha256=trace_sha256(tr), steps=stats.scan_steps,
                wall=wall, launches=R.launch_count)


def golden_phase(device: str):
    """The golden runs, spread over worker processes: each run is bound by
    its host loop, so processes on separate cores share the one card."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    golden = json.loads((ROOT / "tests" / "trace" /
                         "golden_hashes.json").read_text())
    systems = sorted(DEFAULT_SYSTEMS.items())
    workers = min(len(systems), max(1, (os.cpu_count() or 2) - 2))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = [(std, pool.submit(golden_run, std, org, tim, device))
                   for std, (org, tim) in systems]
        results = [(std, f.result()) for std, f in futures]
    print(f"golden command-stream hashes on {device} (3000 cycles; "
          f"{workers} worker processes, {time.perf_counter() - t0:.1f} s):")
    for std, r in results:
        ok = r["n"] == golden[std]["n"] and r["sha256"] == golden[std]["sha256"]
        print(f"  {std:<9} commands {r['n']:>5}  steps {r['steps']:>5}  "
              f"readiness launches {r['launches']:>5}  {r['wall']:7.2f} s  "
              f"{'match' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{std} command stream differs from its golden hash")
        if r["launches"] <= 0:
            fail(f"{std} run did not launch the readiness kernel")


def main_path_phase(device):
    import torch
    from repro_torch.core import (Simulator, avg_probe_latency_ns,
                                  throughput_gbps)
    from repro_torch.kernels import readiness as R
    want = json.loads((ROOT / "tests" /
                       "torch_main_path_stats.json").read_text())
    sim = Simulator(MAIN["standard"], MAIN["org"], MAIN["timing"],
                    device=device)
    R.launch_count = 0
    sim.host_syncs = 0
    t0 = time.perf_counter()
    stats = sim.run(MAIN["n_cycles"], interval=MAIN["interval"],
                    read_ratio=MAIN["read_ratio"], seed=MAIN["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = R.launch_count
    got = stats.to_dict()
    if got != want["stats"]:
        diff = {k: (got[k], want["stats"].get(k)) for k in got
                if got[k] != want["stats"].get(k)}
        fail(f"main-path Stats differ from the reference fixture: {diff}")
    if launches <= 0:
        fail("main path did not launch the readiness kernel")
    steps = stats.scan_steps
    print(f"main path {MAIN['standard']} {MAIN['n_cycles']} cycles: Stats "
          f"== reference fixture; wall {wall:.2f} s, executed steps {steps},"
          f" {steps / wall:.1f} steps/s, {MAIN['n_cycles'] / wall:.1f} "
          f"cycles/s, host syncs {sim.host_syncs}, readiness launches "
          f"{launches}, throughput {throughput_gbps(sim.cspec, stats):.3f} "
          f"GB/s, probe latency "
          f"{avg_probe_latency_ns(sim.cspec, stats):.2f} ns")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda")
    t_start = time.perf_counter()
    print(card_line())

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build("readiness")
    print(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}")

    max_err, krows = kernel_phase(device)
    golden_phase("cuda")
    launches = main_path_phase(device)

    r = krows[MAIN["standard"]]
    bound_by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    print(json.dumps({"kernels": [{
        "name": "readiness_table", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/readiness.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": launches, "max_abs_err": max_err,
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]), "bound_by": bound_by,
        "library_ms": None}]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
