"""End-to-end driver on the port: train a ~98M-param llama-family model
for a few hundred steps on the synthetic pipeline, with checkpoints and
restart (the counterpart of ``examples/train_small_lm.py``).

    PYTHONPATH=src python examples/torch/train_small_lm.py [--steps 300]
        [--device cpu]

This runs the port's whole training path (data -> model -> loss -> AdamW
-> checkpoint manager -> fault-tolerant driver) through
``repro_torch.launch.train``; on the card every attention layer runs the
hand-written flash kernels forward (head dim 64: the sm90 kernel) and
backward.  A second run with the same ``--ckpt-dir`` resumes from its
latest checkpoint.
"""
import argparse
import dataclasses

from repro_torch.configs import get_arch
from repro_torch.configs.base import register_arch
from repro_torch.launch import train as train_launcher


def config():
    """The reference example's llama3-family config (16 x 512 x 8H, 4 kv
    heads, ff 2816, vocab 32000, tied embeddings: 98,189,824 params; its
    comment says ~102M), registered as ``llama3-100m``."""
    base = get_arch("llama3.2-1b")
    return register_arch(dataclasses.replace(
        base, name="llama3-100m", n_layers=16, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2816, head_dim=64, vocab=32_000,
        tie_embeddings=True))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--ckpt-dir", default="results/torch/ckpt_100m")
    args = ap.parse_args(argv)
    cfg = config()
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    extra = [] if args.device is None else ["--device", args.device]
    state, log = train_launcher.main([
        "--arch", "llama3-100m", "--steps", str(args.steps),
        "--seq", str(args.seq), "--batch", str(args.batch),
        "--lr", "6e-4", "--ckpt-dir", args.ckpt_dir,
        "--ckpt-interval", "100"] + extra)
    first = sum(x["loss"] for x in log[:10]) / max(len(log[:10]), 1)
    last = sum(x["loss"] for x in log[-10:]) / max(len(log[-10:]), 1)
    improved = last < first
    print(f"loss: first10={first:.3f} last10={last:.3f} "
          f"({'improved' if improved else 'NOT improved'})")
    return dict(cfg=cfg, state=state, log=log, first=first, last=last,
                improved=improved)


if __name__ == "__main__":
    main()
