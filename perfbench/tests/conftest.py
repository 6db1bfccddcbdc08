"""Shared set-up of the harness's CPU tests: the harness and the program on
the path, and a tiny-width cell driven on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(BENCH / "tools"), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from yardstick.harness import Cell, Run  # noqa: E402
from yardstick.model import Dense  # noqa: E402

TINY = Dense(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=96, vocab=512, norm_eps=1e-6,
             rope_theta=10000.0, qk_norm=False, tie_embeddings=False)
TINY_QK = Dense(name="tiny-qk", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=1, head_dim=16, d_ff=96, vocab=512, norm_eps=1e-6,
                rope_theta=1e6, qk_norm=True, tie_embeddings=True)

TRAIN = {"driver": "train", "batch": 2, "seq": 64, "zipf_a": 1.3,
         "setup_steps": 3, "check_steps": 2,
         "adamw": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                   "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 1,
                   "total_steps": 10000, "moment_dtype": "bfloat16"}}
PREFILL = {"driver": "prefill", "prompt_len": 96, "zipf_a": 1.3,
           "warmup": 1}

# Limits of the tiny cells on the CPU: the program's bf16 against the
# fp32 reference reads under these on every seed tried, the fp8 control
# and the planted faults read over them (test_perfbench_control.py).
TINY_TRAIN_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.007, "delta_gap": 0.03}
TINY_PREFILL_LIMITS = {"token_gap": 0.5, "logit_err": 0.05, "kv_err": 0.04}


def tiny_run(kind: str, seed: int, model=TINY, seconds: float = 0.05,
             limits=None):
    """A :class:`Run` of a tiny cell on the CPU."""
    import torch
    traffic = TRAIN if kind == "train" else PREFILL
    own = {"check": 2, "check_among": 2,
           "limits": limits or (TINY_TRAIN_LIMITS if kind == "train"
                                else TINY_PREFILL_LIMITS)}
    cell = Cell(name=f"tiny.{kind}", config="tiny", chips=1,
                traffic=traffic, own=own)
    return Run(cell=cell, seed=seed, seconds=seconds, traced=False,
               device=torch.device("cpu"), t_start=0.0, model=model)


@pytest.fixture
def drivers():
    from run import load_module
    return {k: load_module(BENCH / "drivers" / f"{k}.py")
            for k in ("train", "prefill")}
