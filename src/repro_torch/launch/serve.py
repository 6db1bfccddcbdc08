"""Serving launcher: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 1000 --max-new 32

The flags of ``repro.launch.serve`` plus ``--device`` (default: the card;
``--device cpu`` runs on the CPU, e.g. with ``--reduced``).  Weights are
random bf16, drawn from ``--seed``; prompts are uniform random tokens
from the same seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serve.step import serve_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)

    timings: dict = {}
    toks, first = serve_batch(cfg, params, prompts, args.max_new,
                              device=dev, timings=timings)
    n_tok = args.batch * args.max_new
    pre, dec = timings["prefill_s"], timings["decode_s"]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"arch={cfg.name} device={where} params={cfg.param_count():,} "
          f"batch={args.batch} prompt={args.prompt_len}: prefill "
          f"{pre * 1e3:.2f} ms, decode {n_tok} tokens in {dec * 1e3:.2f} ms "
          f"({dec * 1e3 / max(args.max_new, 1):.2f} ms/step, "
          f"{n_tok / dec if dec else 0.0:.1f} tok/s; first call, eager)")
    print("sample:", [int(first[0])] + toks[0, :10].tolist())
    return toks


if __name__ == "__main__":
    main()
