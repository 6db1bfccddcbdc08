"""Training launcher: end-to-end driver with checkpointing, restart and
straggler monitoring on one device, the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 200 --seq 128 --batch 8 --device cpu

The reference's flags plus ``--device`` (default: the card; raises
without one).  Weights are random bf16 drawn from ``--seed``, batches
come from ``repro_torch.data.make_batch`` (a function of seed and step),
and checkpoints go to ``--ckpt-dir`` every ``--ckpt-interval`` steps: a
second run with the same directory resumes from the latest one.  Prints
the reference's log lines and, last, one JSON line with the final loss,
the restarts and the straggler events.  ``examples/torch/train_small_lm.py``
drives it at ~100M parameters.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultConfig, StragglerMonitor, run_with_restarts
from repro_torch.train import make_train_step, train_init


def main(argv=None):
    """Parse ``argv`` and train; returns ``(final state, per-step log)``
    (``loss``, ``lr``, ``dt`` per executed step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="override layer count (with --reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps} seq={args.seq} batch={args.batch}",
          flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    state0 = train_init(cfg, init_params(cfg, args.seed, dev), opt_cfg)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    seed=args.seed)

    step_raw = make_train_step(cfg, opt_cfg, microbatch=args.microbatch)
    metrics_log = []

    def make_step():
        def step(state, batch):
            t0 = time.perf_counter()
            state, m = step_raw(state, batch)
            loss = float(m["loss"])
            metrics_log.append({"loss": loss, "lr": float(m["lr"]),
                                "dt": time.perf_counter() - t0})
            if len(metrics_log) % args.log_every == 1:
                print(f"step {len(metrics_log):5d} loss={loss:.4f} "
                      f"lr={float(m['lr']):.2e} "
                      f"dt={metrics_log[-1]['dt']:.2f}s", flush=True)
            return state, m
        return step

    manager = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    monitor = StragglerMonitor(FaultConfig())
    state, history = run_with_restarts(
        make_step=make_step, init_state=state0,
        data_for_step=lambda s: make_batch(cfg, dc, s, device=dev),
        n_steps=args.steps, manager=manager, monitor=monitor,
        meta={"arch": cfg.name})
    print(json.dumps({"final_loss": metrics_log[-1]["loss"] if metrics_log
                      else None,
                      "restarts": history["restarts"],
                      "straggler_events": history["straggler_events"]}))
    return state, metrics_log


if __name__ == "__main__":
    main()
