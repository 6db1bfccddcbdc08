"""Serving launcher: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 1000 --max-new 32

The flags of ``repro.launch.serve`` plus ``--device`` (default: the card;
``--device cpu`` runs on the CPU, e.g. with ``--reduced``) and
``--params``.  Weights are random bf16, drawn from ``--seed``, or read
from ``--params``: an ``.npz`` of the reference's parameter tree as bf16
bit patterns under ``param.<path>`` (the layout of
``tests/torch_serve_fixture.npz``).  Prompts are uniform random tokens
from numpy's generator seeded with ``--seed``, as the reference draws
them: ``(batch, prompt_len)``, or ``(batch, prompt_len, n_codebooks)``
for an audio config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serve.step import serve_batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--params", default=None, metavar="NPZ",
                    help="bf16 weights (param.<path> bit patterns) instead "
                         "of seed-made ones")
    return ap


def load_params(path: str, cfg, device):
    """The weights of an ``.npz`` holding the reference's parameter tree
    as bf16 bit patterns under ``param.<path>``."""
    from repro_torch import convert
    z = np.load(path)
    return convert.lm_params(convert.nest(
        {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}),
        cfg, device)


def run(argv=None) -> dict:
    """Parse ``argv``, serve and print the report; returns the config,
    prompts, ``tokens`` ``(B, max_new[, K])``, ``first`` ``(B[, K])`` and
    timings."""
    args = build_parser().parse_args(argv)
    dev = _device.resolve(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = (init_params(cfg, args.seed, dev) if args.params is None
              else load_params(args.params, cfg, dev))
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.prompt_len)
    if cfg.frontend == "audio_stub":
        shape = shape + (cfg.n_codebooks,)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                              dtype=torch.int32, device=dev)

    timings: dict = {}
    toks, first = serve_batch(cfg, params, prompts, args.max_new,
                              device=dev, timings=timings)
    n_tok = args.batch * args.max_new
    pre, dec = timings["prefill_s"], timings["decode_s"]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    active = (f" active={cfg.active_param_count():,}" if cfg.moe else "")
    print(f"arch={cfg.name} device={where} params={cfg.param_count():,}"
          f"{active} batch={args.batch} prompt={args.prompt_len}: prefill "
          f"{pre * 1e3:.2f} ms, decode {n_tok} tokens in {dec * 1e3:.2f} ms "
          f"({dec * 1e3 / max(args.max_new, 1):.2f} ms/step, "
          f"{n_tok / dec if dec else 0.0:.1f} tok/s; first call, eager)")
    print("sample:", [first[0].tolist()] + toks[0, :10].tolist())
    return dict(cfg=cfg, prompts=prompts, tokens=toks, first=first,
                timings=timings)


def main(argv=None):
    """The CLI: serve and print; returns the decoded tokens."""
    return run(argv)["tokens"]


if __name__ == "__main__":
    main()
