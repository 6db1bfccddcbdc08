"""The port's train step and its entry points on the CPU: the reference's
``tests/models/test_arch_smoke.py`` training tests ported to
``repro_torch`` (every reduced config takes a finite step that moves its
parameters; the loss of the reduced Llama decreases over 10 steps;
microbatching matches the full batch), the remat of the layer groups,
``python -m repro_torch.launch.train`` in a subprocess, and
``examples/torch/train_small_lm.py``'s config against the reference
example's."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, get_arch
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step, train_init
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = sorted(all_archs())
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_runs_and_is_finite(name):
    cfg = get_arch(name).reduced()
    params = init_params(cfg, 1, "cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = train_init(cfg, params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    dc = DataConfig(seq_len=32, global_batch=2)
    new, m = step(state, make_batch(cfg, dc, step=0, device="cpu"))
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    before = next(iter(params.parameters()))
    after = next(iter(new.params.parameters()))
    assert not torch.equal(before, after)
    assert after.requires_grad and after.dtype == torch.bfloat16


def test_loss_decreases_multi_step():
    cfg = get_arch("llama3.2-1b").reduced()
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    state = train_init(cfg, init_params(cfg, 0, "cpu"), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    dc = DataConfig(seq_len=32, global_batch=4)
    losses = []
    for i in range(10):
        state, m = step(state, make_batch(cfg, dc, step=i, device="cpu"))
        losses.append(float(m["loss"]))
    assert min(losses[-3:]) < losses[0], losses


def test_microbatching_matches_full_batch():
    cfg = get_arch("llama3.2-1b").reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = make_batch(cfg, DataConfig(seq_len=16, global_batch=4), 0,
                       device="cpu")
    params = init_params(cfg, 0, "cpu")
    s1 = train_init(cfg, params, opt_cfg)
    s2 = train_init(cfg, params, opt_cfg)
    s1, m1 = make_train_step(cfg, opt_cfg, microbatch=1)(s1, batch)
    s2, m2 = make_train_step(cfg, opt_cfg, microbatch=2)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    a = next(iter(s1.params.parameters())).detach().float().numpy()
    b = next(iter(s2.params.parameters())).detach().float().numpy()
    np.testing.assert_allclose(a, b, atol=5e-3)
    # the step leaves the state it was given as it was
    assert torch.equal(next(iter(params.parameters())),
                       next(iter(init_params(cfg, 0, "cpu").parameters())))


def test_remat_recomputes_groups_and_keeps_the_loss():
    """In training each layer group's forward runs twice (once more in the
    backward pass); the remainder layers once.  The loss is the
    unchecked forward's, and serving (no grad) runs each layer once."""
    cfg = get_arch("recurrentgemma-2b").reduced(n_layers=5)   # 1 group + 2
    params = init_params(cfg, 0, "cpu").requires_grad_(True)
    batch = make_batch(cfg, DataConfig(seq_len=16, global_batch=2), 0,
                       device="cpu")
    calls = []
    orig = M.B.block_apply

    def counted(cfg_, kind, *a, **kw):
        calls.append(kind)
        return orig(cfg_, kind, *a, **kw)

    M.B.block_apply = counted
    try:
        loss, _ = M.logits_and_loss(cfg, params, batch)
        n_fwd = len(calls)
        loss.backward()
        n_all = len(calls)
        with torch.no_grad():
            ref, _ = M.logits_and_loss(cfg, params, batch)
    finally:
        M.B.block_apply = orig
    assert n_fwd == 5 and n_all - n_fwd == 3 and len(calls) - n_all == 5
    torch.testing.assert_close(loss.detach(), ref, rtol=0, atol=0)


def test_launch_train_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch llama3.2-1b --reduced
    --steps 20 --device cpu``: the reference's log lines and a final JSON
    line that parses."""
    # one intra-op thread: beside the suite's other workers, torch's
    # default thread pool oversubscribes the cores (20x slower)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--reduced", "--steps", "20", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-interval", "10"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("arch=llama3.2-1b-reduced params=")
    assert any(ln.startswith("step     1 loss=") for ln in lines)
    doc = json.loads(lines[-1])
    assert np.isfinite(doc["final_loss"]) and doc["restarts"] == 0
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_0000000010",
                                                    "ckpt_0000000020"]


def test_train_small_lm_example_config():
    """The example imports, and its config is the reference example's
    (the same fields changed on llama3.2-1b): 98,189,824 parameters (the
    reference's comment says ~102M; its ``param_count`` says this)."""
    from repro.configs import get_arch as jax_arch
    path = os.path.join(ROOT, "examples", "torch", "train_small_lm.py")
    spec = importlib.util.spec_from_file_location("train_small_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch.configs import base
    try:
        cfg = mod.config()
        assert get_arch("llama3-100m") is cfg
    finally:               # the registry holds the reference's ten again
        base._ARCHS.pop("llama3-100m")
    want = dataclasses.replace(
        jax_arch("llama3.2-1b"), name="llama3-100m", n_layers=16,
        d_model=512, n_heads=8, n_kv_heads=4, d_ff=2816, head_dim=64,
        vocab=32_000, tie_embeddings=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()
    assert cfg.param_count() == 98_189_824
