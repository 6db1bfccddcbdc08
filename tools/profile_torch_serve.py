#!/usr/bin/env python3
"""Profile the PyTorch port's LM serving path on one device.

    PYTHONPATH=src python tools/profile_torch_serve.py [--device cuda]
        [--arch llama3.2-1b] [--reduced] [--batch 4] [--prompt-len 1000]
        [--max-new 32] [--seed 0]

Runs ``serve_batch`` once to warm up and once timed (seed-made bf16
weights, uniform random prompts), printing prefill ms, decode ms per step
and tokens/s.  Then it profiles one prefill and ``--profile-steps``
decode steps with ``torch.profiler``: a table of the device time by
kernel for each, and a JSON summary as the last line with
``prefill_ms``, ``decode_ms_per_step``, ``prefill_device_ms``,
``decode_device_ms_per_step``, ``decode_launches_per_step``,
``decode_ops_per_step`` (top-level operator calls),
``decode_busy_share`` (device time per step over the unprofiled wall
time per step), ``flash_device_ms`` (the flash kernels' device time
per launch in the prefill: ``flash_fwd_sm90_kernel`` at head dim 64/128
in bf16, the ``flash_core_*`` kernels otherwise) and
``flash_share_of_prefill``.
Device numbers are ``null`` when the profiler reports no device work.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--profile-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serve.step import make_prefill_step, serve_batch

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    B, T, N = args.batch, args.prompt_len, args.max_new
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)),
                              dtype=torch.int32, device=dev)
    serve_batch(cfg, params, prompts, 2, device=dev)          # warm-up
    timings: dict = {}
    FA.launch_count = FA.sm90_launch_count = 0
    toks, first = serve_batch(cfg, params, prompts, N, device=dev,
                              timings=timings)
    pre_ms = timings["prefill_s"] * 1e3
    dec_ms = timings["decode_s"] * 1e3 / N
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"{cfg.name} on {name}: {B} x {T} prompt tokens, {N} new: "
          f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms/step "
          f"({B / dec_ms * 1e3:.1f} tokens/s), flash launches: sm90 "
          f"{FA.sm90_launch_count}, CUDA-core {FA.launch_count}")

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"

    def device_rows(prof):
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]

    prefill = make_prefill_step(cfg, T + args.profile_steps)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    with profile(activities=acts) as prof:
        _, cache = prefill(params, M.Batch(tokens=prompts, positions=pos))
        sync()
    pre_rows = device_rows(prof)
    pre_dev = sum(e.self_device_time_total for e in pre_rows) / 1e3
    flash = [e for e in pre_rows if "flash_core_" in e.key
             or "flash_fwd_sm90_kernel" in e.key]
    flash_ms = (sum(e.self_device_time_total for e in flash) / 1e3
                / max(1, sum(e.count for e in flash))) if flash else None
    print("prefill:")
    print(prof.key_averages().table(sort_by=sort, row_limit=12))

    tok = first.reshape(B, 1)
    S = args.profile_steps
    with profile(activities=acts) as prof:
        for i in range(S):
            lg, cache = M.decode_step(cfg, params, cache, M.Batch(
                tokens=tok, positions=torch.full((B, 1), T + i,
                                                 dtype=torch.int32,
                                                 device=dev),
                cache_index=T + i, cache_len=T + i + 1))
            tok = lg[:, -1].argmax(-1).to(torch.int32).reshape(B, 1)
        sync()
    rows = device_rows(prof)
    dec_dev = sum(e.self_device_time_total for e in rows) / 1e3 / S
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    print(f"decode ({S} steps):")
    print(prof.key_averages().table(sort_by=sort, row_limit=12))
    print(json.dumps({
        "arch": cfg.name, "device": args.device, "device_name": name,
        "batch": B, "prompt_len": T, "max_new": N,
        "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
        "decode_tokens_per_s": B / dec_ms * 1e3,
        "prefill_device_ms": pre_dev if pre_rows else None,
        "flash_device_ms": flash_ms,
        "flash_share_of_prefill": (flash_ms * cfg.n_layers / pre_dev
                                   if flash_ms and pre_dev else None),
        "decode_device_ms_per_step": dec_dev if rows else None,
        "decode_launches_per_step": (sum(e.count for e in rows) / S
                                     if rows else None),
        "decode_busy_share": dec_dev / dec_ms if rows else None,
        "decode_ops_per_step": n_ops / S}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
