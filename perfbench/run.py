#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``; its configuration (``configs/<config>.json``), traffic
(``traffic/<traffic>.json``), limits (``workloads/<cell>.json``), driver
(``drivers/<driver>.py``, named by the traffic) and per-layer metrics
(``metrics/<metric>.py``) are files found by name.  The run makes its
weights and inputs from ``--seed``, warms up, measures ``--seconds``,
checks the window's outputs against the plain reference
(``reference/``) and prints one JSON object as the last line of standard
output; with ``--trace 1`` the window runs under ``torch.profiler`` and
the line carries the per-layer metrics instead of the end-to-end ones.
Without a CUDA card, or with fewer cards than the cell asks for, it
exits 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = BENCH_DIR = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def cell_metrics(bench: dict, cell: str) -> tuple:
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [e for e in bench["end_to_end"]
           if "workloads" not in e or cell in e["workloads"]]
    names = {e["name"] for e in e2e}
    layer = [e for e in bench["per_layer"]
             if (cell in e["workloads"] if "workloads" in e
                 else e["moves"] in names)]
    return e2e, layer


def environment():
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own nvcc libraries under ``build/kernels`` there), and PyTorch's
    allocator as training jobs set it (expandable segments: the loss
    head's multi-GiB transients fragment the default allocator's pool
    until a step runs out of memory)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from yardstick.harness import Cell, Run
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell.load(bench, args.workload)

    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    ctx = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              traced=bool(args.trace), device=dev, t_start=T_START)
    ctx.marks.append(("import torch", t_torch - T_START))
    torch.empty(1, device=dev)
    ctx.mark("the card's context")
    driver = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    res = driver.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    out = report(bench, ctx, res, kind, power_limit())
    check_s = time.perf_counter() - T_START - ctx.setup_s - ctx.window_s
    print(f"perfbench: {cell.name} seed {args.seed}: set-up "
          f"{ctx.setup_s:.3f} s, window {ctx.window_s:.3f} s, check and "
          f"report {check_s:.3f} s; set-up marks "
          + ", ".join(f"{k} {v:.3f}" for k, v in ctx.marks), file=sys.stderr)
    print(f"perfbench: readings {json.dumps(res['numbers'])}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def report(bench: dict, ctx, res: dict, kind: str, power_w) -> dict:
    """The result line of a finished run: ``correct``, ``attempted``,
    ``failed``, ``metrics`` (the cell's end-to-end metrics, or with a
    trace its per-layer ones), ``device``, with a trace ``breakdown``, and
    last ``checks``, each compared number beside its limit."""
    from yardstick import compare
    from yardstick.peaks import peaks
    correct, checks = compare.judge(res["numbers"], ctx.cell.own["limits"])
    e2e, layer = cell_metrics(bench, ctx.cell.name)
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"]}
    device = {"platform": "gpu", "kind": kind, "count": ctx.cell.chips,
              "memory_peak_bytes": ctx.peak_bytes, "power_limit_w": power_w}
    if ctx.traced:
        t = ctx.trace
        t.info, t.peak = res["info"], peaks(kind)
        metrics = {}
        for e in layer:
            v = load_module(HERE / "metrics" / f"{e['name']}.py").read(t)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        out["metrics"], out["device"] = metrics, device
        out["breakdown"] = t.breakdown()
    else:
        values = dict(res["e2e"], setup_s=ctx.setup_s,
                      peak_gib=ctx.peak_bytes / GIB)
        out["metrics"] = {e["name"]: {"value": values[e["name"]],
                                      "unit": e["unit"]} for e in e2e}
        out["device"] = device
    out["checks"] = checks
    return out


def power_limit():
    """The card's power limit in watts (``nvidia-smi``), None if unread."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
