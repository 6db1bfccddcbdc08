#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on any mismatch or exception:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main paths with ``nvcc`` into
   ``build/kernels/`` (all sources compiled in parallel) and count the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the
   tensor-core flash kernel's SASS, ``HMMA`` (mma.sync) in the CUDA-core
   one's, and the (max,+) kernels' DPX add-max (``cuobjdump``);
3. hold the readiness kernel against its plain version on the card, bit
   for bit, on random device histories of every default system
   (timestamps below and above 2**24), and time kernel and plain version
   with CUDA events at the main path's shapes; hold the general (max,+)
   kernel of the same source bit for bit against its plain version at the
   reference test's shapes and 2048^3, int32 (wrapping sums) through its
   launcher and fp32 (-3e38 start, -inf rows, a NaN) through
   ``timing_check.maxplus_matmul``, and ``ops.readiness_matrix`` on the
   card against the CPU's, then time it at 128^3 and 2048^3 in both
   dtypes with its bound; then hold the fused
   controller-step kernel against ``step_and_horizon_plain`` on the same
   CUDA tensors, bit for bit in next state, every event field and the
   horizon, on random controller states of every default system (clocks
   from 0 and from 2**24 + 12345; full, half and empty queues with
   arrival ties; refresh units before, at and past the urgent margin;
   LPDDR5/6 banks activating near their ACT-2 deadline; both schedulers,
   refresh on and off, queue depths 8, 32 and 64; 3 channels in one
   launch; 4 cycles in a row, the last without the horizon), and time it
   at the DDR5 main path's shapes: back to back (CUDA events), device
   only (``torch.profiler``) and the plain version per call;
4. hold both flash-attention kernels against their plain version, fp32
   at 2e-5 and bf16 at 2e-2 (the reference's tolerances), every call
   counted on the route ``flash_attention.route`` picks: causal and full,
   D 16/32/64/128, T 100 and 300, GQA rep 1 and 4, both layouts; for the
   tensor-core (sm90) kernel also T 1000 (ragged) and 4096 (the k/v ring
   wraps), rep 8, Tq != Tk (40, 100) and head slices of a fused qkv
   tensor; then time kernel, plain version and
   ``scaled_dot_product_attention`` (the library call, never on a path)
   at the serving path's prefill shape (B 4, T 1000, Hq 32, Hkv 8, D 64,
   bf16, causal), at D 128, and the CUDA-core kernel at phase 8's shape
   in bf16 and fp32 and at the serving shape in fp32, each against SDPA;
5. reproduce the 11 single-spec golden command-stream hashes of
   ``tests/trace/golden_hashes.json`` on ``cuda`` (3000 cycles, interval
   2.0, read ratio 0.7, FR-FCFS, fast-forward on), each run launching the
   fused controller-step kernel once per executed step and the plain
   step never; the runs share the card from worker processes, one per
   spare CPU core, since each is bound by its host loop;
6. run the README's session — DDR5_16Gb_x8 / DDR5_4800B, 20,000 cycles,
   interval 2.0, read ratio 0.8 — with every launch count set to 0 just
   before and read just after, and require its ``Stats`` to equal the
   reference fixture ``tests/torch_main_path_stats.json`` exactly, one
   fused launch per executed step and no call of the plain step; print
   steps/s, cycles/s, ms per step and launches;
7. serve the reduced GQA Llama of ``tests/torch_serve_fixture.npz`` (the
   JAX package's parameters, prompts, tokens and logits) on ``cuda``:
   prefill and teacher-forced decode logits within atol 0.2 / rtol 0.05,
   greedy tokens equal (a token may differ only at a near tie: a top-two
   margin within twice that position's logit difference);
8. serve the reduced ``llama3.2-1b`` (head dim 32: the CUDA-core flash
   kernel's path, whose kernel phase 4 also times at this session's
   attention shape) with every launch count set to 0 just before and read
   just after, prefill logits kernel vs plain version within 2e-2;
9. serve ``llama3.2-1b`` at full width (1,235,814,400 seed-made bf16
   parameters): 4 requests of 1000 prompt tokens, 32 new tokens each,
   with every launch count set to 0 just before and read just after (16
   sm90 flash launches, one per layer, and no CUDA-core one); then the
   same prefill with the kernel's plain version in its place, logits
   within 2e-2, and greedy tokens, teacher-forced with the kernel run's,
   equal wherever the top-two margin exceeds 2e-2;
10. (run right after phase 3) hold the fused controller-step kernel over
    (point x channel) lanes against ``step_lanes_plain`` on the same CUDA
    tensors, bit for bit in next state, every event field and the
    horizon: DDR4, LPDDR5 and HBM3; 1, 5 and 32 points of 1, 2 and 4
    channels; per-point clocks, every third point inactive; reset states
    at clock 0 with refresh stagger on and off, and random states; then
    time one launch at the batched session's 128 lanes (CUDA events back
    to back, ``torch.profiler`` for device time, the plain version);
11. (run before phase 5) the batched latency-throughput session:
    ``Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=4)``,
    ``run_batch(20_000, intervals=[1, 1.5, 2, 3, 4, 6, 8, 16],
    read_ratios=[1.0, 0.8, 0.6, 0.5])``: 32 points, 128 lanes, with every
    launch count set to 0 just before and read just after; every point's
    ``Stats`` must equal ``tests/torch_batch_stats.json``, with one fused
    launch and one host sync per loop iteration and no plain step; print
    wall seconds, loop iterations, point-cycles/s, channel-cycles/s, ms
    and launches per iteration; then 100 cycles of it under
    ``torch.profiler`` (one device-to-host copy per iteration);
12. (in a worker process beside phase 5's runs) multi-channel: reproduce
    ``GOLDEN["DDR4@2ch"]`` on ``cuda``, and the 4-channel HBM3 session of
    ``examples/multichannel.py`` against
    ``tests/torch_multichannel_stats.json``;
13. (run right after phase 10) the modern-controller features: the fused
    kernel vs ``step_and_horizon_plain`` on the same CUDA tensors, bit for
    bit in next state (the BlockHammer sketch and PRAC counters included),
    every event field and the horizon, on DDR4, LPDDR5 (split activation),
    HBM3 and GDDR7 (dual command bus: the sketch halves once per pass),
    with BlockHammer (sketch counts around the threshold), PRAC (a bank at
    the threshold in about half the refresh units) and a link latency of
    80 (arrivals on both sides of the boundary), alone and together, and
    with a user predicate over every ``PredCtx`` field (its mask computed
    on the card; a dual command bus takes one launch per pass), 3
    channels in one launch, clocks from 0 and from 2**24 + 12345, stepped
    through 6 consecutive cycles and then around two ``nREFI`` multiples
    (the sketch's decay cycles); then the kernel at one DDR4 lane with
    BlockHammer off and on, timed back to back (CUDA events) and on the
    device (``torch.profiler``);
14. (run before phase 5) memory systems and predicates: the session of
    ``examples/hetero_system.py`` (DDR5x2 + CXL-DDR4x2@80, 20,000 cycles,
    interval 1.0, read ratio 0.7) with every launch count set to 0 just
    before and read just after: its ``Stats`` and ``per_group`` leaves
    equal ``tests/torch_hetero_stats.json``, with two fused launches (one
    per spec group) and one host sync per loop iteration and no plain
    step; then 100 cycles of it under ``torch.profiler`` (operator calls,
    kernel launches and device-to-host copies per iteration, busy share);
    in worker processes beside phase 5's golden runs: the hetero golden
    hash ``GOLDEN["DDR5x2+DDR4x2@80"]`` (over ``FIELDS + ("group",)``),
    ``run_batch`` over the system and the fixture's predicate sessions
    (BlockHammer on a 2-row hammer and on benign traffic, PRAC on 4 rows
    and the ``no_writes_ever`` user predicate, whose mask rides the
    kernel), each with one fused launch per step and no plain step;
15. (in worker processes beside phase 5's runs) windowed telemetry and
    trace replay, each session with every launch count set to 0 just
    before and read just after, one fused launch per spec group and one
    host sync per loop iteration, no plain step, and its ms per
    iteration printed: the README's DDR5 session at ``telemetry=1000``
    (its ``Stats`` equal ``tests/torch_main_path_stats.json``, its 20
    windows ``tests/torch_telemetry_stats.json``) and the
    ``DDR5x2+DDR4x2@80`` system, 4,000 cycles at ``telemetry=256``; a
    DDR4 source run (4,000 cycles, interval 4.0, read ratio 0.5) through
    ``capture`` and ``to_replay(deps=True)`` (the stream's fingerprint
    equal to ``tests/torch_replay_stats.json``'s) replayed 20,000 cycles
    with ``FrontendConfig(pattern="trace", probes=False)`` (``Stats`` and
    command-stream sha256 equal to the fixture's), the same for the
    hetero system with probes (4,000 cycles), and ``run_batch`` at
    intervals [8, 2] over the DDR4 stream without its arrival clocks
    (probes on).

16. the paper's Fig. 1 sweep through ``repro_torch.dse.execute``: the
    grid of ``benchmarks/bench_latency_throughput.py`` (11 standards x 6
    intervals x 3 read ratios, FR-FCFS, seed 0x1234; ``DSE_FIG1`` of
    ``tests/torch_parity.py``) cut to 5,000 cycles, 198 points in 11
    compile groups, each group one cached batched run with one fused
    launch per loop iteration over its 18 points and one host sync.  In
    the main process while phase 5's workers run: a sweep with a
    violating override (DDR4, ``nRC`` 1) raises ``SpecLintError`` before
    any launch; the sweep on a fresh ``RunCache`` (11 misses, every launch
    count set to 0 just before and read just after) equals
    ``tests/torch_dse_stats.json`` point by point exactly (every column,
    the command counts); a two-point DDR4 ``capture_traces`` sweep gives
    the fixture's sha256 per point; ``python -m repro_torch.dse.sweep
    --standards DDR4,HBM3 --intervals 16,4,1 --cycles 2000 --out
    build/dse_smoke`` exits 0 in a subprocess and its artifact loads.
    After the workers, alone: the same sweep again (0 misses, 11 hits,
    nothing built), held to the fixture the same way, with its wall
    seconds per group and in total, point-cycles/s, ms and launches per
    iteration.

The line before the last is a JSON object with one entry per kernel (its
times, bound and launches; the fused controller step's launches are those
of the batched session, of phases 14 and 15's sessions and of phase 16's
two Fig. 1 sweeps, its times those
of one 128-lane launch; the readiness table and the general (max,+) product, off
every main path, report the main path's 0 launches and their DDR5 and
2048^3 int32 times); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(standard="DDR5", org="DDR5_16Gb_x8", timing="DDR5_4800B",
            n_cycles=20_000, interval=2.0, read_ratio=0.8, seed=0x1234)
#: the batched session's shape (``tests/torch_batch_stats.json``): 8
#: intervals x 4 read ratios over 4 DDR4 channels, 128 lanes
BATCH_POINTS, BATCH_CHANNELS = 32, 4

#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core fp32 rate
#: (integer add/compare/max issue on the same CUDA cores)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
#: H100 SXM data sheet: dense bf16 tensor-core rate
BF16_TENSOR_OPS_PER_S = 989e12

#: the full-width serving session (phase 9) and its prefill attention
#: shape (B, T, Hq, Hkv, D)
LM = dict(arch="llama3.2-1b", params=1_235_814_400, batch=4,
          prompt_len=1000, max_new=32, seed=0)
SERVE_SHAPE = (4, 1000, 32, 8, 64)
#: the reduced serving session (the CUDA-core flash kernel's path)
REDUCED = dict(batch=4, prompt_len=256, max_new=8)
#: flash kernel vs plain version: the reference's tolerances
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the port vs the JAX package's logits: its decode-parity tolerance
FIXTURE_TOL = dict(atol=0.2, rtol=0.05)
#: kernel vs plain version through the whole bf16 model
LM_TOL = dict(atol=2e-2, rtol=2e-2)


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


def queued_ms(fn, reps: int = 20, sleep_cycles: int = 20_000_000):
    """Mean milliseconds per call of ``fn`` on the device with the host
    ahead of it: a sleep kernel (``sleep_cycles`` SM clocks, ~10 ms) holds
    the stream while the host enqueues ``reps`` calls between two events,
    so the events time the calls' device work back to back without host
    gaps, every kernel of a call included.  None (not measured) when the
    host took longer to enqueue them than the sleep lasted."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def device_us(fn, kernel: str, reps: int = 200):
    """Mean device time in µs per launch of the kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler`` (a
    mean over the launches it recorded: it may record fewer than were
    made); None when the profiler reports no device time for it."""
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


def kernel_phase(device):
    """Kernel vs plain version on every default system; timings at the
    main path's (DDR5, one channel) shapes."""
    import torch
    from repro_torch.core import compile_spec
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import readiness as R
    from repro_torch.testing import random_device_state
    max_err, rows = 0, []
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device)
        tab = dp.tables.ready
        for j, clk0 in enumerate((0, (1 << 24) + 12345)):
            st, _ = random_device_state(cspec, dp, device, seed=100 * i + j,
                                        clk0=clk0)
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


MAXPLUS_SHAPES = [(8, 16, 8), (32, 30, 10), (1, 1, 1), (129, 70, 12),
                  (128, 128, 128), (5, 200, 3), (2048, 2048, 2048)]
#: the general (max,+) product's timed shapes
MAXPLUS_TIMED = [(128, 128, 128), (2048, 2048, 2048)]


def maxplus_operands(Q, K, C, dtype, device, seed):
    """T, A on the card: int32 over the whole range (sums wrap), or fp32
    with values on both sides of 2**24, -3e38 entries (some outputs with
    every term at -inf) and, at the small shapes, a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        T = rng.integers(-(1 << 31), 1 << 31, (Q, K), dtype=np.int64)
        A = rng.integers(-(1 << 31), 1 << 31, (K, C), dtype=np.int64)
        T, A = T.astype(np.int32), A.astype(np.int32)
    else:
        T = rng.integers(-(1 << 25), 1 << 25, (Q, K)).astype(np.float32)
        A = rng.integers(-(1 << 10), 1 << 24, (K, C)).astype(np.float32)
        T[rng.random((Q, K)) < 0.2] = -3e38
        A[rng.random((K, C)) < 0.5] = -3e38
        T[0] = -3e38
        A[:, -1] = -3e38
        if Q * K < 1 << 16 and Q > 1:
            T[Q // 2, K // 2] = np.nan
    return (torch.as_tensor(T, device=device),
            torch.as_tensor(A, device=device))


def maxplus_phase(device):
    """The general (max,+) kernel of ``csrc/readiness.cu`` vs its plain
    version, bit for bit: int32 through the launcher (start INT32_MIN) and
    fp32 through ``timing_check.maxplus_matmul`` (start -3e38), at the
    reference test's shapes and 2048^3; ``ops.readiness_matrix`` on the
    card equal to the CPU's on DDR4, LPDDR5 and HBM3; then both dtypes
    timed at 128^3 and 2048^3 (CUDA events back to back, torch.profiler
    device time, the plain version) with the bound: 2 Q K C operations (an
    add and a max) at the CUDA cores' 67 T/s, or T, A and out bytes once
    at 3.35 TB/s."""
    import numpy as np
    import torch
    from repro_torch.core import compile_spec
    from repro_torch._device import sm_count
    from repro_torch.core import device as D
    from repro_torch.kernels import ops
    from repro_torch.kernels import readiness as R
    from repro_torch.kernels.timing_check import NEG, maxplus_matmul
    from repro_torch.testing import random_device_state

    def run(dtype, T, A):
        if dtype == "int32":
            return R.maxplus_cuda(T, A, R.INT32_MIN)
        return maxplus_matmul(T, A)

    def plain(dtype, T, A):
        return R.maxplus_plain(T, A, R.INT32_MIN if dtype == "int32"
                               else NEG)

    checked, max_err = 0, 0.0
    for (Q, K, C), dtype in [(s, d) for s in MAXPLUS_SHAPES
                             for d in ("int32", "float32")]:
        T, A = maxplus_operands(Q, K, C, dtype, device, Q + K + C)
        before = R.launch_count
        got = run(dtype, T, A)
        want = plain(dtype, T, A)
        torch.cuda.synchronize()
        if R.launch_count != before + 1:
            fail(f"maxplus kernel call counted {R.launch_count - before} "
                 "launches")
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"maxplus kernel at {(Q, K, C)} {dtype}: {got.dtype} "
                 f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        # bit for bit: int32 exactly; fp32 with NaN at the same places and
        # the same bits everywhere else
        nan = torch.isnan(got)
        if not torch.equal(nan, torch.isnan(want)):
            fail(f"maxplus kernel's NaNs != plain version's at {(Q, K, C)}")
        g, w = got[~nan], want[~nan]
        bits = (lambda x: x) if dtype == "int32" else \
            (lambda x: x.view(torch.int32))
        err = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
        max_err = max(max_err, err)
        if not torch.equal(bits(g), bits(w)):
            fail(f"maxplus kernel != plain version at {(Q, K, C)} {dtype}: "
                 f"max |diff| {err}")
        checked += 1
    for std in ("DDR4", "LPDDR5", "HBM3"):
        org, tim = {"DDR4": ("DDR4_8Gb_x8", "DDR4_2400R"),
                    "LPDDR5": ("LPDDR5_8Gb_x16", "LPDDR5_6400"),
                    "HBM3": ("HBM3_16Gb", "HBM3_5200")}[std]
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, "cpu", channels=2)
        st, _ = random_device_state(cspec, dp, "cpu", seed=5, clk0=1000,
                                    channels=2)
        rng = np.random.default_rng(5)
        subs = np.stack([rng.integers(0, int(n), 64) for n in
                         cspec.level_counts[1:]], 1).astype(np.int32)
        keys = ops.build_keys(cspec)
        want = ops.readiness_matrix(cspec, keys, cspec.ct_lat, st, subs)
        got = ops.readiness_matrix(cspec, keys, cspec.ct_lat,
                                   D.DeviceState(*(f.to(device) for f in st)),
                                   subs)
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            fail(f"ops.readiness_matrix on the card != on the CPU ({std})")
    print(f"maxplus kernel vs plain version: bit for bit at {checked} "
          f"(shape, dtype) cases (max |diff| {max_err}); ops.readiness_matrix "
          "on the card == on the CPU (DDR4, LPDDR5, HBM3)")
    rows = {}
    for (Q, K, C), dtype in [(s, d) for s in MAXPLUS_TIMED
                             for d in ("int32", "float32")]:
        T, A = maxplus_operands(Q, K, C, dtype, device, 1)
        big = Q * K * C > 1 << 24
        kern_ms = cuda_ms(lambda: run(dtype, T, A), 20 if big else 2000)
        dev_us = device_us(lambda: run(dtype, T, A), "maxplus::",
                           reps=10 if big else 200)
        plain_ms = cuda_ms(lambda: plain(dtype, T, A), 3 if big else 100)
        ops_ms = 2 * Q * K * C / CUDA_CORE_OPS_PER_S * 1e3
        bytes_ms = 4 * (Q * K + K * C + Q * C) / HBM_BYTES_PER_S * 1e3
        plan = R.maxplus_plan(Q, K, C, sm_count(torch.device(device)))
        rows[(Q, K, C, dtype)] = r = dict(
            ms=kern_ms, device_us=dev_us, plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        dev = ("not measured" if dev_us is None
               else f"{dev_us / 1e3:.5f} ms")
        print(f"  maxplus {(Q, K, C)} {dtype} (plan {plan}): kernel "
              f"{kern_ms:.5f} ms back to back, device {dev}, plain "
              f"{plain_ms:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; {r['bound_ms'] / kern_ms:.1%} of it)")
    return max_err, rows


def fused_phase(device):
    """The fused controller-step kernel vs ``step_and_horizon_plain`` on
    every default system and case, each launched as a batch of one point
    at its device clock (the engine's single run); timings at the DDR5
    main path's shapes (one channel, queue depth 32, FR-FCFS, refresh
    on)."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import controller_step as KS
    steps = max_err = 0
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device, channels=3)
        cases = itertools.product(("FRFCFS", "FCFS"), (True, False),
                                  (8, 32, 64), (0, (1 << 24) + 12345))
        for j, (sched, refresh, depth, clk0) in enumerate(cases):
            cfg = ControllerConfig(scheduler=sched, refresh_enabled=refresh)
            cs, clk = T.random_ctrl_state(cspec, dp, device, seed=100 * i + j,
                                          clk0=clk0, depth=depth)
            kcs = T.clone_ctrl(cs)
            for step in range(4):
                before = KS.launch_count
                kh = ph = None
                if step == 3:
                    kcs, kev, _ = T.step_one_point(cspec, dp, cfg, kcs, clk,
                                                   False)
                    cs, pev = C.controller_step_plain(cspec, dp, cfg, cs, clk)
                else:
                    kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, clk)
                    cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg,
                                                           cs, clk)
                torch.cuda.synchronize()
                diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
                if kh is not None:
                    h = int((kh.long() - ph.long()).abs().max())
                    diff.update({"horizon": h} if h else {})
                max_err = max([max_err, *(v for v in diff.values()
                                          if isinstance(v, int))])
                if diff or KS.launch_count != before + 1:
                    fail(f"fused controller step != plain version on {std} "
                         f"({sched}, refresh {refresh}, depth {depth}, clock "
                         f"{clk}, step {step}): {diff}")
                steps += 1
                clk += 1

    # timings at the DDR5 main path's shapes, on a state of its own (the
    # kernel updates its input in place)
    std = MAIN["standard"]
    cspec = compile_spec(std, MAIN["org"], MAIN["timing"])
    dp = D.dyn_params(cspec, device)
    cfg = ControllerConfig()
    cs, clk = T.random_ctrl_state(cspec, dp, device, seed=5, clk0=1000,
                                  depth=cfg.queue_depth, channels=1)
    one = T.one_point(cs, clk)      # the engine's launch: one point
    plan = C.step_plan(cspec, dp, cfg, one[0])
    kern = lambda: C.step_and_horizon(cspec, dp, cfg, *one)
    ms = cuda_ms(kern, 2000)
    dev_us = device_us(kern, "controller_step_kernel")
    pcs = T.clone_ctrl(cs)
    plain_ms = cuda_ms(lambda: C.step_and_horizon_plain(cspec, dp, cfg, pcs,
                                                        clk), 200)
    ms2 = cuda_ms(kern, 2000)
    # bytes: the plan's constants, the state in and out (valid in and out,
    # the rest of the queue in), the clock and flag, the events row out
    inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
    nbytes = (plan.consts.numel() * 4
              + 2 * sum(t.numel() * t.element_size() for t in inout)
              + sum(t.numel() * t.element_size() for t in (
                  cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                  cs.queue.row, cs.queue.arrive, *one[1:]))
              + plan.out.numel() * 4)
    # operations: the table's compare, add and max per present (key, cmd)
    # and bank, and per queue slot its prerequisite, mask and key (about
    # 40 integer operations), for one pass; the horizon's key loop per
    # valid slot and refresh unit
    present = int(dp.tables.ready.present.sum())
    keys = dp.tables.ready.A.shape[0]
    ops = (3 * present * cspec.n_banks + 40 * cfg.queue_depth
           + 3 * keys * (int(cs.queue.valid.sum()) + cspec.n_refresh_units))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"fused controller step vs plain version: {steps} steps on all "
          f"default systems (state, events, horizon: max |diff| {max_err})")
    print(f"  at {std} (1 point of 1 channel at its device clock, as the "
          f"engine launches it; queue depth {cfg.queue_depth}): kernel "
          f"{ms * 1e3:.2f} / {ms2 * 1e3:.2f} us back to back (CUDA events, "
          f"before / after the plain version), device "
          f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} "
          f"(torch.profiler); plain version {plain_ms * 1e3:.2f} us per "
          f"call; bound {max(bytes_ms, ops_ms) * 1e6:.3f} ns ({nbytes} B at "
          f"3.35 TB/s: {bytes_ms * 1e6:.3f} ns; {ops} integer operations at "
          f"67 TOP/s: {ops_ms * 1e6:.3f} ns)")
    return dict(steps=steps, max_err=max_err, ms=ms, ms2=ms2, device_us=dev_us,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def golden_run(std: str, org: str, tim: str, device: str) -> dict:
    """One run of the port at the golden configuration (run in a worker
    process): its command count and digest, executed steps, wall seconds,
    fused-kernel launches and plain-step calls."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import capture, trace_sha256
    sim = Simulator(std, org, tim, device=device,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = capture(sim.cspec, dense)
    return dict(n=len(tr), sha256=trace_sha256(tr), steps=stats.scan_steps,
                wall=wall, launches=KS.launch_count, plain=C.plain_calls)


def golden_phase(device: str, meanwhile=None) -> tuple:
    """The golden runs and the sessions of phases 12, 14 and 15, spread
    over worker processes (the longest first): each run is bound by its
    host loop, so processes on separate cores share the one card.  The
    main process runs ``meanwhile()`` while they do.  Returns the fused
    launches of phase 14's sessions and of phase 15's, and what
    ``meanwhile`` returned."""
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
        p15 = [(job, pool.submit(phase15_run, job, device))
               for job in PHASE15_JOBS]
        jobs = [(job, pool.submit(system_run, job, device))
                for job in SYSTEM_JOBS]
        multi = pool.submit(multichannel_run, device)
        futures = [(std, pool.submit(golden_run, std, org, tim, device))
                   for std, (org, tim) in systems]
        extra = meanwhile() if meanwhile is not None else None
        results = [(std, f.result()) for std, f in futures]
        system_results = [(job, f.result()) for job, f in jobs]
        p15_results = [(job, f.result()) for job, f in p15]
        multi_lines = multi.result()
    print(f"multi-channel on {device} (phase 12, in a worker process):")
    for line in multi_lines:
        print("  " + line)
        if line.startswith("FAILED"):
            fail(line[len("FAILED "):])
    print(f"memory systems and predicates on {device} (phase 14, in worker "
          "processes):")
    doc = hetero_fixture()
    launches = sum(check_system_run(job, r, doc)
                   for job, r in system_results)
    print(f"windowed telemetry and trace replay on {device} (phase 15, in "
          "worker processes):")
    p15_launches = sum(check_phase15(job, r) for job, r in p15_results)
    print(f"golden command-stream hashes on {device} (3000 cycles; "
          f"{workers} worker processes, {time.perf_counter() - t0:.1f} s "
          "with phases 12, 14 and 15):")
    for std, r in results:
        ok = r["n"] == golden[std]["n"] and r["sha256"] == golden[std]["sha256"]
        print(f"  {std:<9} commands {r['n']:>5}  steps {r['steps']:>5}  "
              f"fused launches {r['launches']:>5}  plain steps "
              f"{r['plain']}  {r['wall']:7.2f} s  "
              f"{'match' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{std} command stream differs from its golden hash")
        if r["launches"] != r["steps"] or r["plain"]:
            fail(f"{std} run launched the fused kernel {r['launches']} times "
                 f"in {r['steps']} steps and called the plain step "
                 f"{r['plain']} times")
    return launches, p15_launches, extra


def telemetry_doc(telem) -> dict:
    """A ``Telemetry`` as the lists of ``tests/torch_telemetry_stats.json``."""
    fields = ("reads", "writes", "probe_lat_sum", "probe_cnt",
              "data_bus_busy", "deferred", "occ_sum", "cmd_counts",
              "lat_hist")
    return dict(t_end=telem.t_end.tolist(), groups=[
        {f: getattr(g, f).tolist() for f in fields} for g in telem.groups])


def phase15_run(job: str, device: str) -> dict:
    """One of phase 15's sessions (run in a worker process, every launch
    count set to 0 just before the measured run and read just after): the
    README DDR5 session or the hetero system with windowed telemetry, a
    captured DDR4 or hetero run replayed through ``to_replay(deps=True)``,
    or ``run_batch`` over the DDR4 stream without its arrival clocks.
    Returns what the main process checks."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    from repro_torch.core import FrontendConfig, Simulator, compile_system
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import FIELDS, capture, to_replay, trace_sha256
    tdoc = json.loads((ROOT / "tests" /
                       "torch_telemetry_stats.json").read_text())
    rdoc = json.loads((ROOT / "tests" / "torch_replay_stats.json").read_text())
    msys = compile_system(tdoc["system"])
    out = {}
    if job.startswith("telemetry"):
        r = tdoc["runs"]["session" if job == "telemetry_session" else
                         "hetero"]
        sim = (Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                         device=device) if job == "telemetry_session"
               else Simulator(system=msys, device=device))
        run = lambda: sim.run(r["n_cycles"], interval=r["interval"],
                              read_ratio=r["read_ratio"], seed=r["seed"],
                              telemetry=r["window"])
    else:
        rr = rdoc["runs"]
        hetero = job == "replay_hetero"
        s = rr["hetero_source" if hetero else "source"]

        def simulator(**kw):
            if hetero:
                return Simulator(system=msys, device=device, **kw)
            return Simulator(s["standard"], s["org_preset"],
                             s["timing_preset"], device=device, **kw)
        src = simulator()
        _, dense = src.run(s["n_cycles"], interval=s["interval"],
                           read_ratio=s["read_ratio"], seed=s["seed"],
                           trace=True)
        stream = to_replay(capture(src.msys, dense), src.msys, deps=True)
        if job == "replay_batch":
            stream = dataclasses.replace(stream, arrive=None,
                                         fingerprint="")
        out["fingerprint"] = stream.fingerprint
        # the DDR4 replay without probes, the others with them
        sim = simulator(frontend=FrontendConfig(pattern="trace",
                                                probes=job != "replay"),
                        replay=stream)
        if job == "replay_batch":
            b = rr["batch"]
            run = lambda: sim.run_batch(b["n_cycles"], b["intervals"],
                                        b["read_ratios"], seed=b["seed"])
        else:
            r = rr["hetero_replay" if job == "replay_hetero" else "replay"]
            run = lambda: sim.run(r["n_cycles"], seed=r["seed"], trace=True)
    torch.cuda.synchronize()
    sim.host_syncs = 0
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t0, launches=KS.launch_count,
               plain=C.plain_calls, syncs=sim.host_syncs,
               groups=sim.msys.n_groups)
    if job == "replay_batch":
        pts, stats = res
        out.update(points=[list(x) for x in pts],
                   stats=[stats.point(i).to_dict() for i in range(len(pts))],
                   steps=int(max(stats.scan_steps)))
        return out
    stats, extra = res
    out.update(stats=stats_doc(stats), steps=stats.scan_steps)
    if job.startswith("telemetry"):
        extra.check(stats)
        out["telemetry"] = telemetry_doc(extra)
    else:
        tr = capture(sim.msys, extra)
        fields = FIELDS + (("group",) if job == "replay_hetero" else ())
        out.update(n=len(tr), sha256=trace_sha256(tr, fields))
    return out


PHASE15_JOBS = ("telemetry_session", "replay", "replay_hetero",
                "telemetry_hetero", "replay_batch")


def check_phase15(job: str, r: dict) -> int:
    """Hold a phase-15 session to its fixture and to one fused launch per
    spec group and one host sync per loop iteration, no plain step;
    returns its fused launches."""
    tdoc = json.loads((ROOT / "tests" /
                       "torch_telemetry_stats.json").read_text())
    rdoc = json.loads((ROOT / "tests" / "torch_replay_stats.json").read_text())
    if job == "telemetry_session":
        want = tdoc["session"]
        main = json.loads((ROOT / "tests" /
                           "torch_main_path_stats.json").read_text())["stats"]
        got = {k: v for k, v in r["stats"].items() if k != "per_group"}
        ok = (r["stats"] == want["stats"] and got == main
              and r["telemetry"] == want["telemetry"])
        what = f"{len(r['telemetry']['t_end'])} windows"
    elif job == "telemetry_hetero":
        want = tdoc["hetero"]
        ok = r["stats"] == want["stats"] and r["telemetry"] == want["telemetry"]
        what = f"{len(r['telemetry']['t_end'])} windows"
    elif job == "replay_batch":
        want = rdoc["batch"]
        ok = (r["fingerprint"] == want["fingerprint"]
              and r["points"] == want["points"] and r["stats"] == want["stats"])
        what = f"{len(r['points'])} points"
    else:
        want = rdoc["hetero"] if job == "replay_hetero" else dict(
            rdoc["replay"], fingerprint=rdoc["source"]["fingerprint"])
        stats = (r["stats"] if job == "replay_hetero" else
                 {k: v for k, v in r["stats"].items() if k != "per_group"})
        ok = (r["fingerprint"] == want["fingerprint"] and stats == want["stats"]
              and (r["n"], r["sha256"]) == (want["n"], want["sha256"]))
        what = f"commands {r['n']}"
    ms = r["wall"] / max(r["syncs"], 1) * 1e3
    print(f"  {job:<17} {what:<15} steps {r['steps']:>6}  host syncs "
          f"{r['syncs']:>6}  fused launches {r['launches']:>6} "
          f"({r['groups']} per step)  plain steps {r['plain']}  "
          f"{r['wall']:6.2f} s  {ms:.3f} ms/iteration  "
          f"{'match' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{job}: differs from its fixture (tests/torch_"
             + ("telemetry" if job.startswith("telemetry") else "replay")
             + "_stats.json)")
    if (r["syncs"] != r["steps"] or r["launches"] != r["groups"] * r["steps"]
            or r["plain"]):
        fail(f"{job}: {r['syncs']} host syncs, {r['launches']} fused "
             f"launches and {r['plain']} plain steps for {r['steps']} loop "
             f"iterations ({r['groups']} spec groups)")
    return r["launches"]


def dse_parity():
    """``tests/torch_parity.py``: phase 16's grid (``DSE_FIG1``, the
    constant ``tests/torch_dse_stats.json`` was written from) and its
    ``sweep_spec``."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parity
    return torch_parity


def dse_fig1() -> dict:
    return dse_parity().DSE_FIG1


def dse_spec(run: dict, **kw):
    """The port's ``SweepSpec`` of a fixture run."""
    from repro_torch import dse
    return dse_parity().sweep_spec(dse, run, **kw)


def dse_check(what: str, res, want: dict, launches: int, plain: int,
              readiness: int):
    """Hold a sweep's result to its fixture entry (every column exactly,
    NaN where NaN; the command counts) and to one fused launch per spec
    group and loop iteration, one host sync per iteration, each group's
    iterations its points' most executed cycles, and no plain step."""
    import numpy as np
    for k, col in want["columns"].items():
        got = np.asarray(getattr(res, k))
        ref = np.asarray(col, got.dtype)
        same = got == ref
        if got.dtype.kind == "f":
            same |= np.isnan(got) & np.isnan(ref)
        if not same.all():
            bad = int(np.flatnonzero(~same)[0])
            fail(f"{what}: {k} of point {want['labels'][bad]} is "
                 f"{got[bad]!r}, the reference's {col[bad]!r}")
    counts = [np.asarray(c).tolist() for c in res.cmd_counts]
    if counts != want["cmd_counts"] or res.cmd_names != want["cmd_names"]:
        fail(f"{what}: command counts differ from the reference fixture")
    if [pt.label for pt in res.points] != want["labels"]:
        fail(f"{what}: points differ from the fixture's")
    m = res.meta
    start, expect = 0, 0
    for g in m["groups"]:
        steps = res.scan_steps[start:start + g["n_points"]]
        start += g["n_points"]
        # a capturing group runs its points one at a time
        want_iters = int(sum(steps) if res.traces else max(steps))
        if g["iterations"] != want_iters:
            fail(f"{what}: group {g['system']} ran {g['iterations']} loop "
                 f"iterations for {want_iters}")
        expect += g["iterations"] * g["n_spec_groups"]
    if (m["host_syncs"] != sum(g["iterations"] for g in m["groups"])
            or launches != expect or plain or readiness):
        fail(f"{what}: {launches} fused launches for {expect} (group x "
             f"iteration), {m['host_syncs']} host syncs, {plain} plain "
             f"steps, {readiness} readiness launches")


def dse_run(what: str, spec, cache, device, want: dict):
    """One ``execute`` on the card with every launch count set to 0 just
    before and read just after, held by :func:`dse_check`; returns the
    result, its wall seconds and its fused launches."""
    import torch
    from repro_torch import dse
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    torch.cuda.synchronize()
    KS.launch_count = R.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = dse.execute(spec, cache=cache, devices=[device])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KS.launch_count
    dse_check(what, res, want, launches, C.plain_calls, R.launch_count)
    return res, wall, launches


def dse_phase(device) -> dict:
    """Phase 16, the cold half (run in the main process while the golden
    phase's workers share the card): the lint gate, the Fig. 1 sweep on a
    fresh cache (11 misses), the capture sweep and the CLI in a
    subprocess.  Returns the cache and the launches."""
    import torch
    from repro_torch import dse
    from repro_torch.analysis import SpecLintError
    from repro_torch.core import engine as E
    from repro_torch.kernels import controller_step as KS
    doc = json.loads((ROOT / "tests" / "torch_dse_stats.json").read_text())
    run = dse_fig1()
    if doc["fig1"]["run"] != run:
        fail("phase 16: tests/torch_dse_stats.json was written for another "
             "grid than torch_parity.DSE_FIG1")
    out = {}
    # the lint gate: a violating corner raises before anything launches
    KS.launch_count = 0
    try:
        dse.execute(dse.SweepSpec(
            systems=(("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", {"nRC": 1}),),
            intervals=(8.0,), n_cycles=400), devices=[device])
        fail("phase 16: the sweep with nRC=1 ran past the lint gate")
    except SpecLintError as e:
        if "trc-decomposition" not in e.report.rules_fired() \
                or KS.launch_count:
            fail(f"phase 16: lint gate fired {e.report.rules_fired()} "
                 f"after {KS.launch_count} launches")
    print(f"sweep lint gate on {device}: SpecLintError "
          f"(trc-decomposition) before any launch, fused launches 0")

    cache = E.RunCache()
    res, wall, launches = dse_run("Fig. 1 sweep (cold)", dse_spec(run),
                                  cache, device, doc["fig1"])
    m = res.meta
    G = doc["fig1"]["n_groups"]          # 11
    if (m["n_groups"], m["compile_cache_misses"], m["compile_cache_hits"],
            m["traces"]) != (G, G, 0, G):
        fail(f"Fig. 1 sweep (cold): groups {m['n_groups']}, misses "
             f"{m['compile_cache_misses']}, hits {m['compile_cache_hits']}, "
             f"builds {m['traces']}; want {G}, {G}, 0, {G}")
    print(f"Fig. 1 sweep (cold, beside the golden workers) on {device}: "
          f"{m['n_points']} points in {m['n_groups']} groups x "
          f"{run['n_cycles']} cycles == tests/torch_dse_stats.json; wall "
          f"{wall:.2f} s, loop iterations {m['host_syncs']}, fused launches "
          f"{launches}, plain steps 0; cache misses "
          f"{m['compile_cache_misses']}, first-call seconds "
          f"{m['cache']['first_call_s']}")
    out.update(cache=cache, cold_launches=launches, cold_wall=wall,
               cold_meta=m)

    cap = doc["capture"]
    res, wall, launches = dse_run(
        "capture sweep", dse_spec(cap["run"], capture_traces=True),
        E.RunCache(), device, cap)
    from repro_torch.trace import trace_sha256
    got = [dict(n=len(t), sha256=trace_sha256(t)) for t in res.traces]
    if got != cap["traces"]:
        fail(f"capture sweep: traces {got} != fixture {cap['traces']}")
    print(f"capture sweep on {device}: {len(got)} DDR4 points, traces "
          f"{[t['n'] for t in got]} commands, sha256 == fixture, "
          f"{res.meta['compile_cache_misses']} cache miss, fused launches "
          f"{launches} ({res.meta['host_syncs']} iterations), {wall:.2f} s")

    import os
    cmd = [sys.executable, "-m", "repro_torch.dse.sweep", "--standards",
           "DDR4,HBM3", "--intervals", "16,4,1", "--cycles", "2000",
           "--out", "build/dse_smoke"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        fail(f"sweep CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    loaded = dse.SweepResult.load(str(ROOT / "build" / "dse_smoke"))
    if len(loaded) != 6 or not (loaded.reads_done > 0).all():
        fail(f"sweep CLI artifact: {len(loaded)} points")
    print(f"sweep CLI ({' '.join(cmd[1:])}) exited 0 in "
          f"{time.perf_counter() - t0:.1f} s; artifact "
          f"build/dse_smoke.npz loads with {len(loaded)} points")
    torch.cuda.synchronize()
    return out


def dse_warm_phase(device, cold: dict) -> int:
    """Phase 16, the warm half (alone on the card): the same Fig. 1 sweep
    again on the cold half's cache — 0 misses and 11 hits, nothing built —
    held to the fixture as before, with its wall seconds per group and in
    total, point-cycles/s, ms and launches per loop iteration.  Returns
    the fused launches of both sweeps."""
    doc = json.loads((ROOT / "tests" / "torch_dse_stats.json").read_text())
    run = dse_fig1()
    res, wall, launches = dse_run("Fig. 1 sweep (warm)", dse_spec(run),
                                  cold["cache"], device, doc["fig1"])
    m = res.meta
    G = doc["fig1"]["n_groups"]          # 11
    if (m["compile_cache_misses"], m["compile_cache_hits"],
            m["traces"]) != (0, G, 0):
        fail(f"Fig. 1 sweep (warm): misses {m['compile_cache_misses']}, "
             f"hits {m['compile_cache_hits']}, builds {m['traces']}; want "
             f"0, {G}, 0")
    iters = m["host_syncs"]
    P = m["n_points"] * run["n_cycles"]
    print(f"Fig. 1 sweep (warm, alone) on {device}: {m['n_points']} points "
          f"== tests/torch_dse_stats.json; wall {wall:.2f} s, "
          f"{P / wall:.1f} point-cycles/s, executed point-cycles "
          f"{int(res.scan_steps.sum())}, loop iterations {iters}, "
          f"{wall / iters * 1e3:.3f} ms per iteration, fused launches per "
          f"iteration {launches / iters:.3f}, plain steps 0; cache misses 0, "
          f"hits {m['compile_cache_hits']}, first-call seconds (cold) "
          f"{cold['cold_meta']['cache']['first_call_s']}")
    cold_groups = {g["system"]: g for g in cold["cold_meta"]["groups"]}
    for g in m["groups"]:
        c = cold_groups[g["system"]]
        print(f"  {g['system']:<9} {g['n_points']} points, iterations "
              f"{g['iterations']:>5}, wall {g['wall_s']:6.2f} s warm "
              f"({g['wall_s'] / g['iterations'] * 1e3:.3f} ms/iteration), "
              f"{c['wall_s']:6.2f} s cold")
    return cold["cold_launches"] + launches


def lanes_phase(device):
    """The fused kernel over (point x channel) lanes vs
    ``step_lanes_plain`` on the same CUDA tensors, bit for bit in next
    state, every event field and the horizon: DDR4, LPDDR5 and HBM3, P in
    {1, 5, 32} points of C in {1, 2, 4} channels, per-point clocks with
    every third point inactive (a finished point), reset states at clock 0
    with refresh stagger on and off (negative ``last_ref``) and random
    states, 3 cycles in a row; then one launch timed at the batched
    session's 128 lanes (32 points x 4 DDR4 channels)."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.kernels import controller_step as KS
    systems = [("DDR4", "DDR4_8Gb_x8", "DDR4_2400R"),
               ("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"),
               ("HBM3", "HBM3_16Gb", "HBM3_5200")]
    cfg = ControllerConfig()
    steps = max_err = 0
    for i, ((std, org, tim), P, nch, case) in enumerate(itertools.product(
            systems, (1, 5, 32), (1, 2, 4),
            ("stagger", "in phase", "random"))):
        cspec = compile_spec(std, org, tim, channels=nch)
        dp = D.dyn_params(cspec, device, nch)
        cs, clk, active = T.lane_case(cspec, dp, device, i, P, nch,
                                      case != "random", case == "stagger")
        for step in range(3):
            kcs = T.clone_ctrl(cs)
            before = KS.launch_count
            kcs, kev, kh = C.step_and_horizon(cspec, dp, cfg, kcs, clk,
                                              active)
            cs, pev, ph = C.step_lanes_plain(cspec, dp, cfg, cs, clk, active)
            torch.cuda.synchronize()
            diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
            h = int((kh.long() - ph.long()).abs().max())
            diff.update({"horizon": h} if h else {})
            max_err = max([max_err, *(v for v in diff.values()
                                      if isinstance(v, int))])
            if diff or KS.launch_count != before + 1:
                fail(f"fused step over lanes != plain version on {std} ({P} "
                     f"points x {nch} channels, {case}, step {step}, clocks "
                     f"{clk.tolist()}): {diff}")
            steps += 1
            clk = clk + 1

    # one launch at the batched session's 128 lanes
    P, nch = BATCH_POINTS, BATCH_CHANNELS
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=nch)
    dp = D.dyn_params(cspec, device, nch)
    cs, clk, active = T.lane_case(cspec, dp, device, 5, P, nch, False,
                                  depth=cfg.queue_depth)
    active = torch.ones_like(active)
    plan = C.step_plan(cspec, dp, cfg, cs)
    kern = lambda: C.step_and_horizon(cspec, dp, cfg, cs, clk, active)
    ms = cuda_ms(kern, 2000)
    dev_us = device_us(kern, "controller_step_kernel")
    pcs = T.clone_ctrl(cs)
    plain_ms = cuda_ms(lambda: C.step_lanes_plain(cspec, dp, cfg, pcs, clk,
                                                  active), 3)
    ms2 = cuda_ms(kern, 2000)
    lanes = P * nch
    # bytes: the plan's constants, every lane's state in and out (valid in
    # and out, the rest of the queue in), the clocks and flags, the events
    inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
    nbytes = (plan.consts.numel() * 4
              + 2 * sum(t.numel() * t.element_size() for t in inout)
              + sum(t.numel() * t.element_size() for t in (
                  cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                  cs.queue.row, cs.queue.arrive, clk, active))
              + plan.out.numel() * 4)
    # operations per lane as phase 3 counts them, over all lanes
    present = int(dp.tables.ready.present.sum())
    keys = dp.tables.ready.A.shape[0]
    ops = (lanes * (3 * present * cspec.n_banks + 40 * cfg.queue_depth
                    + 3 * keys * cspec.n_refresh_units)
           + 3 * keys * int(cs.queue.valid.sum()))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"fused controller step over lanes vs plain version: {steps} "
          f"steps (DDR4, LPDDR5, HBM3; 1/5/32 points x 1/2/4 channels; "
          f"state, events, horizon: max |diff| {max_err})")
    print(f"  at {lanes} lanes (DDR4, {P} points x {nch} channels, queue "
          f"depth {cfg.queue_depth}): kernel {ms * 1e3:.2f} / "
          f"{ms2 * 1e3:.2f} us back to back (CUDA events, before / after "
          f"the plain version), device "
          f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} "
          f"(torch.profiler); plain version {plain_ms * 1e3:.1f} us per call "
          f"({P} points in a Python loop); bound "
          f"{max(bytes_ms, ops_ms) * 1e6:.3f} ns ({nbytes} B at 3.35 TB/s: "
          f"{bytes_ms * 1e6:.3f} ns; {ops} integer operations at 67 TOP/s: "
          f"{ops_ms * 1e6:.3f} ns)")
    return dict(steps=steps, max_err=max_err, ms=ms, ms2=ms2,
                device_us=dev_us, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def multichannel_run(device: str) -> list:
    """Phase 12 (run in a worker process): ``GOLDEN["DDR4@2ch"]`` on
    ``cuda`` (fast-forward on), and the 4-channel HBM3 session of
    ``examples/multichannel.py`` against
    ``tests/torch_multichannel_stats.json``, each with one fused launch per
    executed step and no plain step.  Returns the report lines; a line
    that starts with "FAILED" names a mismatch."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import capture, trace_sha256
    lines = []
    golden = json.loads((ROOT / "tests" / "trace" /
                         "golden_hashes.json").read_text())["DDR4@2ch"]
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    mapper="RoBaRaCoCh", device=device,
                    controller=ControllerConfig(refresh_stagger=False))
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = capture(sim.cspec, dense)
    if len(tr) != golden["n"] or trace_sha256(tr) != golden["sha256"]:
        lines.append("FAILED DDR4@2ch command stream differs from its "
                     "golden hash")
    if KS.launch_count != stats.scan_steps or C.plain_calls:
        lines.append(f"FAILED DDR4@2ch launched the fused kernel "
                     f"{KS.launch_count} times in {stats.scan_steps} steps, "
                     f"plain steps {C.plain_calls}")
    lines.append(f"DDR4@2ch golden hash on {device}: commands {len(tr)}, "
                 f"steps {stats.scan_steps}, fused launches "
                 f"{KS.launch_count}, plain steps 0, {wall:.2f} s: match")

    doc = json.loads((ROOT / "tests" /
                      "torch_multichannel_stats.json").read_text())
    r = doc["run"]
    sim = Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                    channels=r["channels"], mapper=r["mapper"], device=device)
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats = sim.run(r["n_cycles"], interval=r["interval"],
                    read_ratio=r["read_ratio"], seed=r["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = stats.to_dict()
    if got != doc["stats"]:
        diff = {k: (got[k], doc["stats"].get(k)) for k in got
                if got[k] != doc["stats"].get(k)}
        lines.append(f"FAILED 4-channel HBM3 Stats differ from the reference "
                     f"fixture: {diff}")
    if KS.launch_count != stats.scan_steps or C.plain_calls:
        lines.append(f"FAILED 4-channel HBM3 run launched the fused kernel "
                     f"{KS.launch_count} times in {stats.scan_steps} steps, "
                     f"plain steps {C.plain_calls}")
    lines.append(f"4-channel {r['standard']} {r['n_cycles']} cycles on "
                 f"{device}: Stats == reference fixture; wall {wall:.2f} s "
                 f"(in a worker process), executed steps {stats.scan_steps}, "
                 f"{stats.scan_steps / wall:.1f} steps/s, "
                 f"{r['n_cycles'] * r['channels'] / wall:.1f} "
                 f"channel-cycles/s, fused launches {KS.launch_count}, plain "
                 "steps 0")
    return lines


def predicate_kernel_phase(device):
    """Phase 13: the fused kernel vs ``step_and_horizon_plain`` with the
    modern-controller features, then one DDR4 lane timed with BlockHammer
    off and on."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import controller_step as KS
    features = [(3, 0, 0, False), (0, 4, 0, False), (0, 0, 80, False),
                (3, 4, 80, False), (2, 3, 0, False), (0, 0, 0, True),
                (3, 4, 80, True)]
    steps = max_err = 0
    for i, (std, (bh, prac, link, user), clk0) in enumerate(
            itertools.product(("DDR4", "LPDDR5", "HBM3", "GDDR7"), features,
                              (0, (1 << 24) + 12345))):
        org, tim = DEFAULT_SYSTEMS[std]
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device, channels=3)
        cfg = ControllerConfig(scheduler=("FRFCFS", "FCFS")[i % 2],
                               blockhammer_threshold=bh,
                               prac_threshold=prac,
                               extra_predicates=(T.reads_every_field,)
                               if user else ())
        # user predicates on a dual bus: one launch per pass
        per_step = 2 if user and cspec.dual_command_bus else 1
        cs, clk = T.predicate_ctrl_state(cspec, dp, device, seed=300 + i,
                                         bh=bh, prac=prac, link=link,
                                         clk0=clk0)
        kcs = T.clone_ctrl(cs)
        clocks = T.predicate_clocks(clk, dp.nREFI, 6)
        for n, t in enumerate(clocks):
            last = n == len(clocks) - 1         # the step without horizon
            before = KS.launch_count
            kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, t,
                                            not last, link)
            if last:
                cs, pev = C.controller_step_plain(cspec, dp, cfg, cs, t,
                                                  link)
            else:
                cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg, cs,
                                                       t, link)
            torch.cuda.synchronize()
            diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
            if not last:
                h = int((kh.long() - ph.long()).abs().max())
                diff.update({"horizon": h} if h else {})
            max_err = max([max_err, *(v for v in diff.values()
                                      if isinstance(v, int))])
            if diff or KS.launch_count != before + per_step:
                fail(f"fused step != plain version on {std} (BlockHammer "
                     f"{bh}, PRAC {prac}, link {link}, user predicate "
                     f"{user}, clock {t}): {diff}")
            steps += 1

    # one DDR4 lane (the engine's launch: one point at its device clock),
    # BlockHammer off and on; the sketch costs 8 KB in and 8 KB out
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = D.dyn_params(cspec, device)
    times, bound = {}, {}
    for bh in (0, 8, 0, 8):
        cfg = ControllerConfig(blockhammer_threshold=bh)
        cs, clk = T.predicate_ctrl_state(cspec, dp, device, seed=7, bh=8,
                                         clk0=1000, channels=1)
        one = T.one_point(cs, clk)
        kern = lambda: C.step_and_horizon(cspec, dp, cfg, *one)
        ms = cuda_ms(kern, 2000)
        dev_us = device_us(kern, "controller_step_kernel")
        times.setdefault(bh, []).append((ms, dev_us))
        # bytes, as phase 3 counts them, plus the sketch in and out when on
        plan = C.step_plan(cspec, dp, cfg, one[0])
        inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
        nbytes = (plan.consts.numel() * 4
                  + 2 * sum(t.numel() * t.element_size() for t in inout)
                  + sum(t.numel() * t.element_size() for t in (
                      cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                      cs.queue.row, cs.queue.arrive, *one[1:]))
                  + plan.out.numel() * 4
                  + (2 * cs.bh_sketch.numel() * 4 if bh else 0))
        bound[bh] = (nbytes, nbytes / HBM_BYTES_PER_S * 1e9)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"
    print(f"fused controller step with BlockHammer, PRAC, link latency and a "
          f"user predicate vs plain version: {steps} steps on DDR4, LPDDR5, "
          f"HBM3, GDDR7 (state "
          f"with sketch and PRAC counters, events, horizon: max |diff| "
          f"{max_err})")
    for bh, runs in times.items():
        print(f"  DDR4, 1 lane, BlockHammer {'on (8)' if bh else 'off'}: "
              "back to back "
              + " / ".join(f"{ms * 1e3:.2f}" for ms, _ in runs)
              + " us (CUDA events, in turns off/on/off/on), device "
              + " / ".join(fmt(d) for _, d in runs) + " us (torch.profiler); "
              f"bound {bound[bh][1]:.3f} ns ({bound[bh][0]} B at 3.35 TB/s)")
    return dict(steps=steps, max_err=max_err, times=times)


def stats_doc(stats) -> dict:
    """``Stats.to_dict()`` of one run plus every ``per_group`` leaf as
    lists: the layout of ``tests/torch_hetero_stats.json``."""
    d = stats.to_dict()
    d["per_group"] = [{k: v.cpu().tolist() for k, v in ch._asdict().items()}
                      for ch in stats.per_group]
    return d


def no_writes_ever(cspec, ctx):
    """The fixture's user predicate (``tests/core/test_controllers.py``)."""
    return ctx.cand_cmd != cspec.id_WR


def hetero_fixture() -> dict:
    return json.loads((ROOT / "tests" /
                       "torch_hetero_stats.json").read_text())


def system_run(job: str, device: str) -> dict:
    """One of phase 14's worker sessions (run in a worker process, every
    launch count set to 0 just before and read just after): the hetero
    golden run, ``run_batch`` over the system, or a predicate session of
    the fixture.  Returns what the main process checks."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import (ControllerConfig, FrontendConfig,
                                  Simulator, compile_system)
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import FIELDS, capture, trace_sha256
    doc = hetero_fixture()
    if job == "hetero_golden":
        msys = compile_system(doc["system"])
        sim = Simulator(system=msys, device=device,
                        controller=ControllerConfig(scheduler="FRFCFS"))
        run = lambda: sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    elif job == "batch":
        b = doc["batch"]["run"]
        sim = Simulator(system=doc["system"], device=device)
        run = lambda: sim.run_batch(b["n_cycles"], b["intervals"],
                                    b["read_ratios"], seed=b["seed"])
    else:
        p = doc["predicates"][job]["run"]
        ctrl = dict(p["controller"])
        if "extra_predicates" in ctrl:
            ctrl["extra_predicates"] = tuple(
                {"no_writes_ever": no_writes_ever}[n]
                for n in ctrl["extra_predicates"])
        sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device=device,
                        controller=ControllerConfig(**ctrl),
                        frontend=FrontendConfig(**p["frontend"]))
        if p["rows"]:
            sim.cspec.rows = p["rows"]
        run = lambda: sim.run(p["n_cycles"], interval=p["interval"],
                              read_ratio=p["read_ratio"])
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0, launches=KS.launch_count,
               plain=C.plain_calls, syncs=sim.host_syncs)
    if job == "hetero_golden":
        stats, dense = res
        tr = capture(sim.msys, dense)
        out.update(n=len(tr), sha256=trace_sha256(tr, FIELDS + ("group",)),
                   steps=stats.scan_steps)
    elif job == "batch":
        pts, stats = res
        out.update(points=[list(x) for x in pts],
                   stats=[stats_doc(stats.point(i)) for i in range(len(pts))],
                   steps=int(max(stats.scan_steps)))
    else:
        out.update(stats=stats_doc(res), steps=res.scan_steps)
    return out


SYSTEM_JOBS = ("blockhammer", "blockhammer_benign", "prac", "no_writes_ever",
               "hetero_golden", "batch")


def check_system_run(job: str, r: dict, doc: dict) -> int:
    """Hold a worker's system session to the fixture ``doc`` and to its
    launch and sync counts; returns its fused launches."""
    groups = len(doc["system"]) if job in ("hetero_golden", "batch") else 1
    if job == "hetero_golden":
        golden = json.loads((ROOT / "tests" / "trace" /
                             "golden_hashes.json").read_text())[
            "DDR5x2+DDR4x2@80"]
        ok = r["n"] == golden["n"] and r["sha256"] == golden["sha256"]
        what = f"commands {r['n']}"
    elif job == "batch":
        ok = (r["points"] == doc["batch"]["points"]
              and r["stats"] == doc["batch"]["stats"])
        what = f"{len(r['points'])} points"
    else:
        want = doc["predicates"][job]["stats"]
        ok = r["stats"] == want
        what = f"deferred {r['stats']['deferred']}"
    print(f"  {job:<19} {what:<18} steps {r['steps']:>6}  host syncs "
          f"{r['syncs']:>6}  fused launches {r['launches']:>6}  plain steps "
          f"{r['plain']:>5}  {r['wall']:7.2f} s  "
          f"{'match' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{job}: differs from " + ("its golden hash"
                                        if job == "hetero_golden" else
                                        "tests/torch_hetero_stats.json"))
    if (r["syncs"] != r["steps"] or r["launches"] != groups * r["syncs"]
            or r["plain"]):
        fail(f"{job}: {r['syncs']} host syncs, {r['launches']} fused "
             f"launches and {r['plain']} plain steps for {r['steps']} loop "
             f"iterations ({groups} spec groups)")
    return r["launches"]


def hetero_session_phase(device):
    """Phase 14 in the main process: ``examples/hetero_system.py``'s
    session against the fixture, with two fused launches (one per spec
    group) and one host sync per loop iteration and no plain step; then
    100 cycles of it under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (Simulator, avg_probe_latency_ns,
                                  compile_system, peak_gbps, throughput_gbps)
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    doc = hetero_fixture()
    r = doc["session"]["run"]
    msys = compile_system(doc["system"])
    sim = Simulator(system=msys, device=device)
    sim.run(50, interval=r["interval"], read_ratio=r["read_ratio"])
    torch.cuda.synchronize()
    sim.host_syncs = 0
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats = sim.run(r["n_cycles"], interval=r["interval"],
                    read_ratio=r["read_ratio"], seed=r["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain, iters = KS.launch_count, C.plain_calls, sim.host_syncs
    got = stats_doc(stats)
    if got != doc["session"]["stats"]:
        diff = {k: (got[k], doc["session"]["stats"].get(k)) for k in got
                if got[k] != doc["session"]["stats"].get(k)}
        fail(f"hetero session Stats differ from the reference fixture: "
             f"{diff}")
    if iters != stats.scan_steps or launches != 2 * iters or plain:
        fail(f"hetero session: {iters} host syncs and {launches} fused "
             f"launches for {stats.scan_steps} loop iterations, plain steps "
             f"{plain}")

    window = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.host_syncs = 0
        KS.launch_count = 0
        t1 = time.perf_counter()
        sim.run(window, interval=r["interval"], read_ratio=r["read_ratio"])
        torch.cuda.synchronize()
        win_wall = time.perf_counter() - t1
    win_iters, win_fused = sim.host_syncs, KS.launch_count
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        fail("hetero session: the profiler saw no device events, so the "
             "device-to-host reads per iteration were not measured")
    dtoh = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
    kernels = sum(e.count for e in dev if not e.key.startswith("Memcpy")
                  and not e.key.startswith("Memset"))
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    if dtoh != win_iters:
        fail(f"hetero session: {dtoh} device-to-host copies in {win_iters} "
             "loop iterations, want one each")
    print(f"hetero session {msys.label} ({msys.n_channels} channels, "
          f"{msys.n_groups} spec groups), {r['n_cycles']} cycles on "
          f"{device}: Stats and per-group leaves == reference fixture; wall "
          f"{wall:.2f} s, loop iterations {iters}, {wall / iters * 1e3:.3f} "
          f"ms per iteration, {r['n_cycles'] / wall:.1f} cycles/s, fused "
          f"launches per iteration {launches / iters:.3f}, plain steps 0; "
          f"throughput {throughput_gbps(msys, stats):.3f} GB/s of "
          f"{peak_gbps(msys):.3f}, probe latency "
          f"{avg_probe_latency_ns(msys, stats):.2f} ns")
    print(f"  profile of {window} cycles ({win_iters} iterations, "
          f"{win_wall:.3f} s): operator calls per iteration "
          f"{n_ops / win_iters:.1f}, device kernel launches per iteration "
          f"{kernels / win_iters:.1f} (fused {win_fused / win_iters:.3f}), "
          f"device-to-host copies per iteration {dtoh / win_iters:.3f} "
          f"(torch.profiler), device ms per iteration "
          f"{dev_ms / win_iters:.4f}, busy share "
          f"{dev_ms / 1e3 / win_wall:.1%}")
    return launches


def batched_phase(device, lane_device_us):
    """The batched latency-throughput session: ``run_batch`` of 32 load
    points over 4 DDR4 channels (128 lanes), 20,000 cycles, with every
    launch count set to 0 just before and read just after; each point's
    ``Stats`` must equal ``tests/torch_batch_stats.json``, with one fused
    launch and one host sync per loop iteration and no plain step.  Then
    100 cycles of the same session under ``torch.profiler``: device-to-host
    copies per iteration (must be 1) and device time per iteration.
    ``lane_device_us`` is phase 10's device time of one 128-lane launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    doc = json.loads((ROOT / "tests" / "torch_batch_stats.json").read_text())
    r = doc["run"]
    sim = Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                    channels=r["channels"], device=device)
    sim.run_batch(50, r["intervals"], r["read_ratios"])      # warm-up
    torch.cuda.synchronize()
    sim.host_syncs = 0
    KS.launch_count = R.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    pts, stats = sim.run_batch(r["n_cycles"], r["intervals"],
                               r["read_ratios"], seed=r["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain, iters = KS.launch_count, C.plain_calls, sim.host_syncs
    if [list(p) for p in pts] != doc["points"]:
        fail(f"batched session points {pts} != fixture {doc['points']}")
    for i, want in enumerate(doc["stats"]):
        got = stats.point(i).to_dict()
        if got != want:
            diff = {k: (got[k], want.get(k)) for k in got
                    if got[k] != want.get(k)}
            fail(f"batched session point {pts[i]}: Stats differ from the "
                 f"reference fixture: {diff}")
    steps = [int(s) for s in stats.scan_steps]
    if iters != max(steps) or launches != iters or plain or R.launch_count:
        fail(f"batched session: {iters} host syncs and {launches} fused "
             f"launches for {max(steps)} loop iterations, plain steps "
             f"{plain}, readiness launches {R.launch_count}")
    P, nch, n = len(pts), r["channels"], r["n_cycles"]

    window = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.host_syncs = 0
        sim.run_batch(window, r["intervals"], r["read_ratios"])
        torch.cuda.synchronize()
    win_iters = sim.host_syncs
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dtoh = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / win_iters
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    if not dev:
        fail("batched session: the profiler saw no device events, so the "
             "device-to-host reads per iteration were not measured")
    if dtoh != win_iters:
        fail(f"batched session: {dtoh} device-to-host copies in "
             f"{win_iters} loop iterations, want one each")
    ms_it = wall / iters * 1e3
    lane_us = ("not measured" if lane_device_us is None
               else f"{lane_device_us:.3f} us")
    print(f"batched session {r['standard']} {P} points x {nch} channels "
          f"({P * nch} lanes), {n} cycles on {device}: Stats == reference "
          f"fixture for every point; wall {wall:.2f} s, loop iterations "
          f"{iters}, executed point-cycles {sum(steps)}, "
          f"{P * n / wall:.1f} point-cycles/s, {P * nch * n / wall:.1f} "
          f"channel-cycles/s, {ms_it:.3f} ms per iteration, fused launches "
          f"per iteration {launches / iters:.3f}, plain steps 0, fused "
          f"kernel device "
          f"{lane_us} per 128-lane launch (phase 10)")
    print(f"  profile of {window} cycles ({win_iters} iterations): "
          f"device-to-host copies per iteration {dtoh / win_iters:.3f} "
          f"(torch.profiler), device ms per iteration {dev_ms}, operator "
          f"calls per iteration {n_ops / win_iters:.1f}")
    return launches


def main_path_phase(device):
    import torch
    from repro_torch.core import (Simulator, avg_probe_latency_ns,
                                  throughput_gbps)
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    want = json.loads((ROOT / "tests" /
                       "torch_main_path_stats.json").read_text())
    sim = Simulator(MAIN["standard"], MAIN["org"], MAIN["timing"],
                    device=device)
    KS.launch_count = R.launch_count = C.plain_calls = 0
    sim.host_syncs = 0
    t0 = time.perf_counter()
    stats = sim.run(MAIN["n_cycles"], interval=MAIN["interval"],
                    read_ratio=MAIN["read_ratio"], seed=MAIN["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain, dense = KS.launch_count, C.plain_calls, R.launch_count
    got = stats.to_dict()
    if got != want["stats"]:
        diff = {k: (got[k], want["stats"].get(k)) for k in got
                if got[k] != want["stats"].get(k)}
        fail(f"main-path Stats differ from the reference fixture: {diff}")
    steps = stats.scan_steps
    if launches != steps or plain or dense:
        fail(f"main path launched the fused kernel {launches} times in "
             f"{steps} steps, the readiness kernels {dense} times and "
             f"called the plain step {plain} times")
    print(f"main path {MAIN['standard']} {MAIN['n_cycles']} cycles: Stats "
          f"== reference fixture; wall {wall:.2f} s, executed steps {steps},"
          f" {steps / wall:.1f} steps/s, {MAIN['n_cycles'] / wall:.1f} "
          f"cycles/s, {wall / steps * 1e3:.3f} ms per step, host syncs "
          f"{sim.host_syncs}, fused controller-step launches {launches}, "
          f"plain steps {plain}, readiness-table launches {dense}, "
          f"throughput {throughput_gbps(sim.cspec, stats):.3f} GB/s, probe "
          f"latency {avg_probe_latency_ns(sim.cspec, stats):.2f} ns")
    return launches, dense


def flash_call(FA, q, k, v, causal: bool, head_axis: int, want):
    """One call of a flash entry point on the card: the route's counter
    goes up by one and the other's not at all; returns ``(route, max
    |diff|)`` against ``want`` (the plain version in ``q``'s layout)."""
    import torch
    kind = FA.route(q.dtype, q.shape[-1])
    before = (FA.launch_count, FA.sm90_launch_count)
    if head_axis == 1:
        got = FA.gqa_flash_attention(q, k, v, causal=causal)
    else:
        got = FA.flash_attention_bthd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    step = (0, 1) if kind == "sm90" else (1, 0)
    after = (FA.launch_count, FA.sm90_launch_count)
    if tuple(x - y for x, y in zip(after, before)) != step:
        fail(f"flash {kind} call counted launches {before} -> {after}")
    if got.shape != want.shape or got.dtype != q.dtype:
        fail(f"flash {kind} output {tuple(got.shape)} {got.dtype}")
    return kind, (got.float() - want.float()).abs().max().item()


def flash_phase(device):
    """Both flash kernels vs the plain version on every listed case, and
    timings per dtype and head dim."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(7)
    t = lambda x: x.transpose(1, 2)
    worst = {}                   # (route, dtype, D) -> max |diff|
    cases = 0

    def check(q, k, v, causal, head_axis, label):
        nonlocal cases
        qp, kp, vp = (q, k, v) if head_axis == 1 else (t(q), t(k), t(v))
        want = FA.attention_plain(qp, kp, vp, causal=causal,
                                  sm_scale=q.shape[-1] ** -0.5)
        if head_axis == 2:
            want = t(want)
        kind, err = flash_call(FA, q, k, v, causal, head_axis, want)
        dt = str(q.dtype).split(".")[-1]
        if err > FLASH_TOL[dt]:
            fail(f"flash {kind} kernel != plain version ({label}, {dt}, "
                 f"causal={causal}, D={q.shape[-1]}): max |diff| {err}")
        key = (kind, dt, q.shape[-1])
        worst[key] = max(worst.get(key, 0.0), err)
        cases += 1

    def rand(*shape, dtype=torch.bfloat16, scale=0.3):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dtype)

    # both routes: fp32 and bf16, D 16-128, T 100/300, rep 1/4, layouts
    for dt, causal, D, T, rep in itertools.product(
            ("float32", "bfloat16"), (True, False), (16, 32, 64, 128),
            (100, 300), (1, 4)):
        q, k, v = (rand(2, h, T, D, dtype=getattr(torch, dt))
                   for h in (2 * rep, 2, 2))
        check(q, k, v, causal, 1, f"T={T}, rep={rep}, (B, H, T, D)")
        check(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(),
              causal, 2, f"T={T}, rep={rep}, (B, T, H, D)")
    # the tensor-core kernel: ragged T 1000, T 4096 (the k/v ring wraps
    # 16 times), GQA rep 8, Tq != Tk, unscaled inputs, and head slices of
    # a fused (B, T, Hq + 2 Hkv, D) qkv tensor
    for causal, D in itertools.product((True, False), (64, 128)):
        for T, rep in itertools.product((1000, 4096), (1, 4, 8)):
            q, k, v = (rand(2, T, h, D, scale=1.0) for h in (2 * rep, 2, 2))
            check(q, k, v, causal, 2, f"T={T}, rep={rep}")
        q, k, v = rand(2, 40, 8, D), rand(2, 100, 2, D), rand(2, 100, 2, D)
        check(q, k, v, causal, 2, "Tq=40, Tk=100")
        check(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(),
              causal, 1, "Tq=40, Tk=100, (B, H, T, D)")
        qkv = rand(2, 300, 8 + 2 * 2, D)
        check(*qkv.split([8, 2, 2], dim=2), causal, 2, "fused qkv view")
    print(f"flash kernels vs plain version, {cases} calls, each counted "
          "on its route; max |diff| by route, dtype and head dim:")
    for (kind, dt, D), e in sorted(worst.items()):
        print(f"  {kind:<9} {dt:<9} D {D:>3}: {e:.3e} (tolerance "
              f"{FLASH_TOL[dt]:g})")
    max_err = {kind: max(e for (r, _, _), e in worst.items() if r == kind)
               for kind in ("cuda_core", "sm90")}

    # per dtype and D: times at (B 2, Hq 8, Hkv 2, T 300), causal; the
    # bound counts 2 B Hq T^2 D operations at the type's peak rate (fp32
    # on CUDA cores, bf16 on tensor cores) and q, k, v, o bytes once
    print("per launch at (B 2, Hq 8, Hkv 2, T 300) causal, CUDA events "
          "back to back:")
    print(f"  {'dtype':<9} {'D':>3} {'route':<9} {'kernel_us':>10} "
          f"{'plain_us':>9} {'bound_us':>9}")
    for dt, D in itertools.product(("bfloat16", "float32"), (16, 32, 64,
                                                             128)):
        dtype = getattr(torch, dt)
        q, k, v = (rand(2, h, 300, D, dtype=dtype) for h in (8, 2, 2))
        kern_us = cuda_ms(lambda: FA.gqa_flash_attention(q, k, v), 50) * 1e3
        plain_us = cuda_ms(lambda: FA.attention_plain(
            q, k, v, causal=True, sm_scale=D ** -0.5), 20) * 1e3
        rate = BF16_TENSOR_OPS_PER_S if dt == "bfloat16" else \
            CUDA_CORE_OPS_PER_S
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        bound_us = max(2 * 2 * 8 * 300 * 300 * D / rate,
                       nbytes / HBM_BYTES_PER_S) * 1e6
        print(f"  {dt:<9} {D:>3} {FA.route(dtype, D):<9} {kern_us:>10.2f} "
              f"{plain_us:>9.2f} {bound_us:>9.3f}")
    return max_err


def flash_timing(device, B, T, Hq, Hkv, D, kernel: str,
                 dtype: str = "bfloat16"):
    """One flash kernel at a path's shape, causal in the model's layout:
    back-to-back times, device time per call (``queued_ms``) and per
    launch (``torch.profiler``, the kernel whose name contains
    ``kernel``: one launch a call), the plain version's and
    ``scaled_dot_product_attention``'s (the library call, never on the
    path), and the bound: ``2 B Hq T^2 D`` operations (multiply-adds of
    both products over the causal half) at 989 TFLOP/s in bf16 or 67
    TFLOP/s in fp32 (CUDA cores), against q, k, v and o bytes once at 3.35
    TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v = (torch.randn(B, T, h, D, generator=gen, device=device)
               .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv))
    t = lambda x: x.transpose(1, 2)
    kern = lambda: FA.flash_attention_bthd(q, k, v, causal=True)
    plain = lambda: FA.attention_plain(t(q), t(k), t(v), causal=True,
                                       sm_scale=D ** -0.5)
    err = (kern().float() - t(plain()).float()).abs().max().item()
    if err > FLASH_TOL[dtype]:
        fail(f"flash {kernel} != plain version at "
             f"{(B, T, Hq, Hkv, D)} {dtype}: max |diff| {err}")
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)
    sdpa_err = (t(kern()).float() - sdpa().float()).abs().max().item()
    kern_ms = cuda_ms(kern, 50)
    dev_us = device_us(kern, kernel, reps=20)
    plain_ms = cuda_ms(plain, 10)
    sdpa_ms = cuda_ms(sdpa, 50)
    kern_ms2 = cuda_ms(kern, 50)
    kern_q, sdpa_q = queued_ms(kern), queued_ms(sdpa)
    flops = 2 * B * Hq * T * T * D
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else \
        CUDA_CORE_OPS_PER_S
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fmt = lambda x, scale=1: ("not measured" if x is None
                              else f"{x * scale:.4f} ms")
    print(f"{kernel} at (B, T, Hq, Hkv, D) = {(B, T, Hq, Hkv, D)} {dtype} "
          f"causal: max |diff| vs plain {err:.3e}, vs SDPA {sdpa_err:.3e}; "
          f"kernel {kern_ms:.4f} / {kern_ms2:.4f} ms back to back (CUDA "
          f"events, before / after SDPA), device {fmt(kern_q)} queued, "
          f"{fmt(dev_us, 1e-3)} torch.profiler; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms back to back, "
          f"device {fmt(sdpa_q)} queued; bound "
          f"{max(ops_ms, bytes_ms):.6f} ms ({flops / 1e9:.4f} GFLOP at "
          f"{rate / 1e12:.0f} TFLOP/s: {ops_ms:.6f} ms; {nbytes / 1e6:.2f} "
          f"MB at 3.35 TB/s: {bytes_ms:.6f} ms)")
    return dict(max_err=err, ms=kern_ms, device_us=dev_us,
                plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def sass_counts(lib_path, required, shown=(), what="kernel") -> str:
    """Instructions whose SASS mnemonic starts with each of ``required``
    and ``shown`` in a built library, from the toolkit's ``cuobjdump``;
    fails if one of ``required`` is missing, "not available" without
    ``cuobjdump``."""
    import shutil
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if not tool:
        return "not available (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode:
        return f"not available (cuobjdump exited {out.returncode})"
    lines = [ln.split() for ln in out.stdout.splitlines()
             if ln.strip().startswith("/*")]
    n = {op: sum(any(tok.startswith(op) for tok in ln) for ln in lines)
         for op in (*required, *shown)}
    if not all(n[op] for op in required):
        fail(f"{what} SASS lacks one of {required}: {n}")
    return ", ".join(f"{op} {c}" for op, c in n.items())


@contextlib.contextmanager
def plain_attention():
    """Inside: the model's prefill attention runs the kernel's plain
    version (for the comparisons of phases 8 and 9 only)."""
    from repro_torch.kernels import flash_attention as FA
    kernel = FA.flash_attention_bthd

    def plain(q, k, v, *, causal=True, sm_scale=None):
        t = lambda x: x.transpose(1, 2)
        return t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                    sm_scale=sm_scale))

    FA.flash_attention_bthd = plain
    try:
        yield
    finally:
        FA.flash_attention_bthd = kernel


def teacher_forced(cfg, params, prompts, seq, device):
    """Prefill logits and the decode logits of feeding ``seq[:, i]`` at
    position T + i, each ``(B, V)`` fp32."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.step import make_prefill_step
    B, T = prompts.shape
    n = seq.shape[1]
    pos = torch.arange(T, dtype=torch.int32, device=device)[None].repeat(B, 1)
    lg, cache = make_prefill_step(cfg, T + n)(
        params, M.Batch(tokens=prompts, positions=pos))
    out = [lg[:, -1]]
    for i in range(n):
        lg, cache = M.decode_step(cfg, params, cache, M.Batch(
            tokens=seq[:, i:i + 1],
            positions=torch.full((B, 1), T + i, dtype=torch.int32,
                                 device=device),
            cache_index=T + i, cache_len=T + i + 1))
        out.append(lg[:, -1])
    return out


def margins(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def fixture_phase(device):
    """The reduced GQA Llama against the JAX package's fixture."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import ModelConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.step import serve_batch
    z = np.load(ROOT / "tests" / "torch_serve_fixture.npz")
    fields = json.loads(str(z["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}),
        cfg, device)
    prompts = torch.as_tensor(z["prompts"], device=device)
    n = z["tokens"].shape[1]
    before = FA.sm90_launch_count
    toks, first = serve_batch(cfg, params, prompts, n, device=device)
    if FA.sm90_launch_count - before != cfg.n_layers:
        fail("fixture run: sm90 flash kernel launched "
             f"{FA.sm90_launch_count - before} times, want {cfg.n_layers}")
    want_seq = np.concatenate([z["first"][:, None], z["tokens"]], 1)
    got = teacher_forced(cfg, params, prompts,
                         torch.as_tensor(want_seq[:, :n], device=device),
                         device)
    got = torch.stack(got, 1).cpu().numpy()                 # (B, n+1, V)
    want = np.concatenate([z["prefill_logits"][:, None], z["decode_logits"]],
                          1)
    diff = float(np.abs(got - want).max())
    if not np.allclose(got, want, **FIXTURE_TOL):
        fail(f"fixture logits differ from the JAX package's beyond "
             f"{FIXTURE_TOL}: max |diff| {diff}")
    # free-running greedy tokens: while a request's tokens agree, its inputs
    # are the teacher-forced ones, so a token may differ only where the JAX
    # top-two margin is within twice that position's max |diff|; after such
    # a near-tie flip the request's later tokens are not compared
    got_seq = np.concatenate([first.cpu().numpy()[:, None],
                              toks.cpu().numpy()], 1)
    tie = margins(torch.as_tensor(want)).numpy() \
        <= 2 * np.abs(got - want).max(-1)
    compared = flips = 0
    for b in range(got_seq.shape[0]):
        for i in range(got_seq.shape[1]):
            compared += 1
            if got_seq[b, i] == want_seq[b, i]:
                continue
            if not tie[b, i]:
                fail(f"fixture greedy token differs at request {b}, "
                     f"position {i}: {got_seq[b, i]} != {want_seq[b, i]}")
            flips += 1
            break
    equal = bool((got_seq == want_seq).all())
    print(f"fixture (reduced GQA {cfg.name}, {cfg.n_heads} q heads / {cfg.n_kv_heads} kv heads, head_dim {cfg.head_dim}) on "
          f"{device}: prefill + teacher-forced decode logits within "
          f"{FIXTURE_TOL} of the JAX package's (max |diff| {diff:.3e}); "
          f"greedy tokens: {compared} of {got_seq.size} compared, "
          f"{flips} near-tie flips; whole sequences equal: {equal}")


def lm_phase(device):
    """Phase 9: the full-width llama3.2-1b serving session."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import readiness as R
    from repro_torch.models import init_params
    from repro_torch.serve.step import serve_batch
    cfg = get_arch(LM["arch"])
    t0 = time.perf_counter()
    params = init_params(cfg, LM["seed"], device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != LM["params"] or cfg.param_count() != LM["params"]:
        fail(f"{cfg.name}: {n_params} parameters, want {LM['params']}")
    rng = np.random.default_rng(LM["seed"])
    B, T, N = LM["batch"], LM["prompt_len"], LM["max_new"]
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)),
                              dtype=torch.int32, device=device)
    serve_batch(cfg, params, prompts[:, :64], 2, device=device)   # warm-up

    torch.cuda.reset_peak_memory_stats(device)
    timings: dict = {}
    FA.launch_count = FA.sm90_launch_count = 0
    R.launch_count = 0
    toks, first = serve_batch(cfg, params, prompts, N, device=device,
                              timings=timings)
    launches = FA.sm90_launch_count
    if launches != cfg.n_layers or FA.launch_count or R.launch_count:
        fail(f"serving session launched the sm90 flash kernel {launches} "
             f"times, the CUDA-core one {FA.launch_count} times and the "
             f"readiness kernels {R.launch_count} times, want "
             f"{cfg.n_layers} (one per layer), 0 and 0")
    peak = torch.cuda.max_memory_allocated(device)
    seq = torch.cat([first[:, None], toks], 1)
    if seq.shape != (B, N + 1) or int(seq.min()) < 0 \
            or int(seq.max()) >= cfg.vocab:
        fail(f"serving session tokens out of range: {tuple(seq.shape)}")

    kern = teacher_forced(cfg, params, prompts, seq[:, :N], device)
    if not all(bool(torch.isfinite(x).all()) for x in kern):
        fail("serving session: non-finite logits")
    with plain_attention():
        plain = teacher_forced(cfg, params, prompts, seq[:, :N], device)
    if FA.sm90_launch_count != 2 * cfg.n_layers or FA.launch_count:
        fail("the plain-version prefill launched a kernel")
    pre_diff = (kern[0] - plain[0]).abs().max().item()
    if not torch.allclose(kern[0], plain[0], **LM_TOL):
        fail(f"full-width prefill logits, kernel vs plain version: max "
             f"|diff| {pre_diff} beyond {LM_TOL}")
    pl = torch.stack(plain, 1)                              # (B, N+1, V)
    checked = margins(pl) > LM_TOL["atol"]
    same = pl.argmax(-1) == seq
    if not bool(same[checked].all()):
        fail("full-width greedy tokens differ between kernel and plain "
             "version where the top-two margin exceeds "
             f"{LM_TOL['atol']}")
    dec_diff = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    pre, dec = timings["prefill_s"], timings["decode_s"]
    print(f"serving session {cfg.name} on {device}: {n_params:,} bf16 "
          f"parameters (init {init_s:.2f} s), {B} requests x {T} prompt "
          f"tokens, {N} new tokens each; prefill {pre * 1e3:.2f} ms "
          f"({B * T / pre:.0f} prompt tokens/s); decode {dec * 1e3:.2f} ms = "
          f"{dec * 1e3 / N:.3f} ms per step ({B * N / dec:.1f} tokens/s); "
          f"end to end {B * N / (pre + dec):.1f} new tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; flash launches: sm90 {launches}, "
          f"CUDA-core {FA.launch_count} (readiness {R.launch_count})")
    print(f"  kernel vs plain version through the model: prefill logits max "
          f"|diff| {pre_diff:.3e}, teacher-forced decode logits max |diff| "
          f"{dec_diff:.3e}; greedy tokens equal at {int(checked.sum())} of "
          f"{checked.numel()} positions with a top-two margin above "
          f"{LM_TOL['atol']} ({int(same.sum())} equal in all)")
    return launches


def reduced_shape():
    """The prefill attention shape (B, T, Hq, Hkv, D) of phase 8."""
    from repro_torch.configs import get_arch
    cfg = get_arch(LM["arch"]).reduced()
    return (REDUCED["batch"], REDUCED["prompt_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim)


def reduced_phase(device):
    """The reduced llama3.2-1b (``launch/serve.py --reduced``: 2 heads of
    head dim 32, bf16), the path of the CUDA-core flash kernel: 4 requests
    of 256 prompt tokens, 8 new tokens each, with every launch count set to
    0 just before and read just after; then its prefill logits, kernel vs
    plain version, within 2e-2."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.serve.step import serve_batch
    cfg = get_arch(LM["arch"]).reduced()
    params = init_params(cfg, LM["seed"], device)
    rng = np.random.default_rng(LM["seed"])
    B, T, N = REDUCED["batch"], REDUCED["prompt_len"], REDUCED["max_new"]
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)),
                              dtype=torch.int32, device=device)
    FA.launch_count = FA.sm90_launch_count = 0
    toks, first = serve_batch(cfg, params, prompts, N, device=device)
    launches = FA.launch_count
    if launches != cfg.n_layers or FA.sm90_launch_count:
        fail(f"reduced session launched the CUDA-core flash kernel "
             f"{launches} times and the sm90 one {FA.sm90_launch_count} "
             f"times, want {cfg.n_layers} and 0")
    seq = torch.cat([first[:, None], toks], 1)
    kern = teacher_forced(cfg, params, prompts, seq[:, :1], device)
    with plain_attention():
        plain = teacher_forced(cfg, params, prompts, seq[:, :1], device)
    diff = (kern[0] - plain[0]).abs().max().item()
    if not (torch.isfinite(kern[0]).all()
            and torch.allclose(kern[0], plain[0], **LM_TOL)):
        fail(f"reduced prefill logits, kernel vs plain version: max |diff| "
             f"{diff} beyond {LM_TOL}")
    print(f"reduced session {cfg.name} (heads {cfg.n_heads}, head_dim "
          f"{cfg.head_dim}) on {device}: {B} x {T} prompt tokens, {N} new "
          f"each; flash launches: CUDA-core {launches}, sm90 0; prefill "
          f"logits kernel vs plain max |diff| {diff:.3e}")
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
    from repro_torch.serve.step import exact_matmuls
    exact_matmuls()        # fp32 products in full fp32, bf16 reduce in fp32
    device = torch.device("cuda")
    t_start = time.perf_counter()
    print(card_line())
    seconds = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build("readiness", "controller_step", "flash_attention",
                       "flash_attention_sm90")
    print(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        # the full -Xptxas -v report goes beside the library; stdout gets
        # each entry's registers and any spill
        path = build.library_path(name).with_suffix(".nvcc.log")
        path.write_text(log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sorted(set(re.findall(r"\d+ bytes spill stores", log))
                        - {"0 bytes spill stores"})
        print(f"nvcc {name}: {len(regs)} entries, registers "
              f"{min(map(int, regs), default=0)}-"
              f"{max(map(int, regs), default=0)}, spills "
              f"{spills or 'none'} (log: {path.relative_to(ROOT)})")
    print("sm90 flash kernel SASS: " + sass_counts(
        build.library_path("flash_attention_sm90"), ("HGMMA", "UTMALDG"),
        what="sm90 flash kernel"))
    # mma.sync (HMMA) for bf16, ldmatrix (LDSM), cp.async (LDGSTS); the
    # (max,+) kernels' DPX add-max (VIADDMNMX) and fp32 max (FMNMX)
    print("CUDA-core flash kernel SASS: " + sass_counts(
        build.library_path("flash_attention"), ("HMMA",), ("LDSM", "LDGSTS"),
        what="CUDA-core flash kernel"))
    print("readiness / (max,+) kernels SASS: " + sass_counts(
        build.library_path("readiness"), (), ("VIADDMNMX", "FMNMX",
                                               "LDGSTS")))

    max_err, krows = timed("3 readiness", kernel_phase, device)
    mp_err, mp = timed("3 maxplus", maxplus_phase, device)
    fused = timed("3 fused", fused_phase, device)
    lanes = timed("10 lanes", lanes_phase, device)
    preds = timed("13 predicates", predicate_kernel_phase, device)
    flash_err = timed("4 flash", flash_phase, device)
    # each flash kernel at its path's shape (timed before the golden phase's
    # worker processes: after them the profiler may report no device time)
    sm90 = flash_timing(device, *SERVE_SHAPE, kernel="flash_fwd_sm90_kernel")
    flash_timing(device, *SERVE_SHAPE[:4], 128, kernel="flash_fwd_sm90_kernel")
    core = flash_timing(device, *reduced_shape(), kernel="flash_core_")
    flash_timing(device, *reduced_shape(), kernel="flash_core_",
                 dtype="float32")
    flash_timing(device, *SERVE_SHAPE, kernel="flash_core_", dtype="float32")
    # the batched and hetero sessions' profile windows also need the
    # profiler's device time: they run before the golden phase's workers
    batch_launches = timed("11 batched", batched_phase, device,
                           lanes["device_us"])
    hetero_launches = timed("14 hetero session", hetero_session_phase,
                            device)
    # phase 16's cold half runs in this process beside the workers, its
    # warm half alone after them
    system_launches, p15_launches, dse_cold = timed(
        "5, 12, 14, 15 in workers; 16 cold", golden_phase, "cuda",
        lambda: dse_phase(device))
    dse_launches = timed("16 warm", dse_warm_phase, device, dse_cold)
    _, launches = timed("6 main path", main_path_phase, device)
    timed("7 fixture", fixture_phase, device)
    core_launches = timed("8 reduced", reduced_phase, device)
    sm90_launches = timed("9 serving", lm_phase, device)

    r = krows[MAIN["standard"]]
    big = mp[(*MAXPLUS_TIMED[-1], "int32")]
    bound_by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"

    def flash_row(name, source, launches, t, err):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": "src/repro/kernels/flash_attention.py:73",
                "launches": launches, "max_abs_err": max(err, t["max_err"]),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [{
        "name": "readiness_table", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/readiness.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": launches, "max_abs_err": max_err,
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]), "bound_by": bound_by,
        "library_ms": None}, {
        "name": "maxplus_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/readiness.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": launches, "max_abs_err": mp_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}, {
        "name": "controller_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/controller_step.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": (batch_launches + hetero_launches + system_launches
                     + p15_launches + dse_launches),
        "max_abs_err": max(fused["max_err"], lanes["max_err"],
                           preds["max_err"]),
        "ms": lanes["ms"], "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound_ms"], "bound_by": lanes["bound_by"],
        "library_ms": None},
        flash_row("flash_attention", "flash_attention.cu", core_launches,
                  core, flash_err["cuda_core"]),
        flash_row("flash_attention_sm90", "flash_attention_sm90.cu",
                  sm90_launches, sm90, flash_err["sm90"])]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s; phases "
          f"{json.dumps(seconds)}", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
