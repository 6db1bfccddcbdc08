#!/usr/bin/env python3
"""Time the port's (max,+) kernel (``csrc/readiness.cu``) on one CUDA card,
against the card's own issue rate for one (max,+) step.

    PYTHONPATH=src python tools/bench_maxplus.py [--sizes 128,2048]
    PYTHONPATH=src python tools/bench_maxplus.py --table

First a microbenchmark: a kernel of 16 independent (max,+) chains per
thread on every SM, int32 (``__viaddmax_s32``, one DPX instruction per
step) and fp32 (an add and a NaN-propagating max, as the kernel's fp32
step), timed with CUDA events: steps per second and per SM clock (at the
clock ``nvidia-smi`` reads afterwards).  Then for each cube ``Q = K = C =
n`` of ``--sizes``, int32 through the launcher and fp32 through
``timing_check.maxplus_matmul``: the tile configuration, the device time
per launch (``torch.profiler``), the time back to back (CUDA events), and
that time as a share of two floors: the operations bound (an add and a
max per step at the CUDA cores' 67 T/s) and the issue floor (``n^3``
steps at the measured rate).  The last line is a JSON object of the rows.

``--table`` times the readiness table (``readiness_table_launch`` of the
same source) instead, on every default system at the main path's shape
(one channel, the state of ``chip_smoke.py``'s phase 3): the device time
per launch and the time back to back.  Run it from two checkouts in one
call to compare two versions of the kernel.
Needs a card and ``nvcc``: without them it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CUDA_CORE_OPS_PER_S = 67e12       # H100 SXM data sheet, fp32 non-tensor

ISSUE_SRC = r"""
#include <cuda_runtime.h>
constexpr int N = 16;
__global__ void chains_i32(int* out, int iters) {
  int acc[N], x[N];
  for (int j = 0; j < N; ++j) { acc[j] = threadIdx.x * j; x[j] = threadIdx.x ^ (77 * j); }
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = __viaddmax_s32(x[j], i, acc[j]);
  int s = 0;
  for (int j = 0; j < N; ++j) s ^= acc[j];
  if (s == 123456789) out[0] = s;
}
__global__ void chains_f32(int* out, int iters) {
  float acc[N], x[N];
  for (int j = 0; j < N; ++j) { acc[j] = threadIdx.x * j; x[j] = threadIdx.x ^ (77 * j); }
  for (int i = 0; i < iters; ++i) {
    const float y = (float)i;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = __fadd_rn(x[j], y);
      asm("max.NaN.f32 %0, %0, %1;" : "+f"(acc[j]) : "f"(t));
    }
  }
  float s = 0.f;
  for (int j = 0; j < N; ++j) s += acc[j];
  if (s == 123456789.f) out[0] = 1;
}
extern "C" int chains(int f32, int iters, int blocks, int threads, float* ms) {
  int* out;
  cudaMalloc(&out, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2; ++rep) {           // the second is timed
    cudaEventRecord(a);
    if (f32) chains_f32<<<blocks, threads>>>(out, iters);
    else chains_i32<<<blocks, threads>>>(out, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
  }
  cudaEventElapsedTime(ms, a, b);
  cudaFree(out);
  return (int)cudaGetLastError();
}
"""


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def issue_rates(n_sm: int) -> dict:
    """Steps per second of the (max,+) chains, int32 and fp32."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "bench_maxplus_issue.so"
    src = out.with_suffix(".cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(ISSUE_SRC)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS[:-2], "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.chains.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float)]
    rates = {}
    iters, blocks, threads = 20_000, 8 * n_sm, 256
    for name, f32 in (("int32", 0), ("float32", 1)):
        ms = ctypes.c_float()
        if lib.chains(f32, iters, blocks, threads, ctypes.byref(ms)):
            raise SystemExit(f"bench_maxplus: the {name} chains failed")
        rates[name] = 16 * iters * blocks * threads / (ms.value * 1e-3)
    rates["sm_clock_mhz"] = float(smi("clocks.sm"))
    return rates


def table_times(dev, cuda_ms, device_us) -> list:
    """The readiness table's device time per launch and back-to-back time
    on every default system, at the state of ``chip_smoke.py``'s phase 3
    (one channel, timestamps above 2**24)."""
    import torch
    from repro_torch.core import compile_spec
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import readiness as R
    from repro_torch.testing import random_device_state
    rows = []
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, dev)
        tab = dp.tables.ready
        st, _ = random_device_state(cspec, dp, dev, seed=100 * i + 1,
                                    clk0=(1 << 24) + 12345)
        fn = lambda: R.readiness_table_cuda(tab, st.last_issue, st.win_ring)
        if not torch.equal(fn(), R.readiness_table_plain(
                tab, st.last_issue, st.win_ring)):
            raise SystemExit(f"bench_maxplus: readiness table != plain "
                             f"version on {std}")
        row = dict(std=std, ms=cuda_ms(fn, 2000),
                   device_us=device_us(fn, "readiness_table_kernel",
                                       reps=500))
        rows.append(row)
        dev_us = "not measured" if row["device_us"] is None else \
            f"{row['device_us']:.3f} us"
        print(f"readiness table {std}: device {dev_us}, back to back "
              f"{row['ms'] * 1e3:.3f} us")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="128,2048")
    ap.add_argument("--table", action="store_true",
                    help="time the readiness table instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_maxplus: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_us, maxplus_operands
    from repro_torch._device import sm_count
    from repro_torch.kernels import readiness as R
    from repro_torch.kernels.timing_check import maxplus_matmul
    dev = torch.device("cuda")
    print(smi("name,power.limit"))
    if args.table:
        rows = table_times(dev, cuda_ms, device_us)
        print(json.dumps(dict(table=rows)))
        return 0
    n_sm = sm_count(dev)
    rates = issue_rates(n_sm)
    clock = rates["sm_clock_mhz"] * 1e6
    for name in ("int32", "float32"):
        print(f"(max,+) issue rate, {name}: {rates[name] / 1e12:.3f} T "
              f"steps/s = {rates[name] / n_sm / clock:.1f} steps per SM "
              f"clock at {clock / 1e6:.0f} MHz")
    rows = []
    for n in (int(x) for x in args.sizes.split(",")):
        for dtype in ("int32", "float32"):
            T, A = maxplus_operands(n, n, n, dtype, dev, 1)
            fn = ((lambda: R.maxplus_cuda(T, A, R.INT32_MIN))
                  if dtype == "int32" else (lambda: maxplus_matmul(T, A)))
            big = n ** 3 > 1 << 24
            ms = cuda_ms(fn, 20 if big else 2000)
            dev_us = device_us(fn, "maxplus::", reps=10 if big else 200)
            bound_ms = 2 * n ** 3 / CUDA_CORE_OPS_PER_S * 1e3
            floor_ms = n ** 3 / rates[dtype] * 1e3
            row = dict(n=n, dtype=dtype, plan=R.maxplus_plan(n, n, n, n_sm),
                       ms=ms, device_us=dev_us, bound_ms=bound_ms,
                       issue_floor_ms=floor_ms)
            rows.append(row)
            dev_ms = "not measured" if dev_us is None else \
                f"{dev_us / 1e3:.5f} ms"
            print(f"{n}^3 {dtype} (plan {row['plan']}): device {dev_ms}, "
                  f"back to back {ms:.5f} ms; operations bound "
                  f"{bound_ms:.5f} ms ({bound_ms / ms:.1%}), issue floor "
                  f"{floor_ms:.5f} ms ({floor_ms / ms:.1%})")
    print(json.dumps(dict(rates=rates, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
