"""Checkpoint/restart, restore onto a device, straggler monitor and
gradient compression of the port (``repro_torch.checkpoint``,
``repro_torch.runtime``): the reference's
``tests/runtime/test_checkpoint_fault.py`` ported, on the CPU, plus the
int8 compressor against the reference's on the same array, bit for
bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    reshard_state, save_checkpoint,
                                    tree_paths)
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (FaultConfig, StragglerMonitor,
                                 make_int8_compressor, run_with_restarts)
from repro_torch.train import make_train_step, train_init
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def small():
    cfg = get_arch("llama3.2-1b").reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    return cfg, init_params(cfg, 0, "cpu"), opt_cfg


def _leaves(state) -> list:
    return list(tree_paths(state).values())


def _assert_states_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


def test_checkpoint_roundtrip(tmp_path, small):
    cfg, params, opt_cfg = small
    state = train_init(cfg, params, opt_cfg)
    state, _ = make_train_step(cfg, opt_cfg)(state, make_batch(
        cfg, DataConfig(seq_len=16, global_batch=2), 0, device="cpu"))
    p = save_checkpoint(str(tmp_path / "ck"), 7, state, {"arch": cfg.name})
    restored, manifest = load_checkpoint(p, like=state)
    assert manifest["step"] == 7 and manifest["arch"] == cfg.name
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    _assert_states_equal(state, restored)
    assert next(iter(restored.params.parameters())).requires_grad
    flat, _ = load_checkpoint(p)
    assert flat["opt/m/layers.0.wq"].dtype == torch.bfloat16


def test_checkpoint_atomic_overwrite(tmp_path, small):
    cfg, params, opt_cfg = small
    state = train_init(cfg, params, opt_cfg)
    p = str(tmp_path / "ck")
    save_checkpoint(p, 1, state)
    save_checkpoint(p, 2, state)      # overwrite must not corrupt
    _, manifest = load_checkpoint(p)
    assert manifest["step"] == 2
    assert sorted(x.name for x in tmp_path.iterdir()) == ["ck"]


def test_manager_rolling_gc(tmp_path, small):
    cfg, params, opt_cfg = small
    state = train_init(cfg, params, opt_cfg)
    man = CheckpointManager(str(tmp_path), interval=2, keep=2)
    for s in range(1, 9):
        man.maybe_save(s, state)
    assert man.all_steps() == [6, 8]


def test_run_with_restarts_recovers(tmp_path, small):
    """A step that crashes twice must resume from checkpoint and finish."""
    cfg, params, opt_cfg = small
    state0 = train_init(cfg, params, opt_cfg)
    dc = DataConfig(seq_len=16, global_batch=2)
    raw = make_train_step(cfg, opt_cfg)
    crashes = {"left": 2}

    def make_step():
        def step(state, batch):
            state, m = raw(state, batch)
            if int(state.opt.step) == 5 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise RuntimeError("injected node failure")
            return state, m
        return step

    man = CheckpointManager(str(tmp_path), interval=2, keep=3)
    state, hist = run_with_restarts(
        make_step=make_step, init_state=state0,
        data_for_step=lambda s: make_batch(cfg, dc, s, device="cpu"),
        n_steps=8, manager=man, cfg=FaultConfig(max_restarts=5,
                                                ckpt_interval=2))
    assert hist["restarts"] == 2
    assert int(state.opt.step) >= 8


def test_restart_determinism(tmp_path, small):
    """Crash-and-resume must land on the same final params as a clean run
    (pure step + deterministic data => exact recovery)."""
    cfg, params, opt_cfg = small
    dc = DataConfig(seq_len=16, global_batch=2)
    raw = make_train_step(cfg, opt_cfg)

    clean = train_init(cfg, params, opt_cfg)
    for s in range(6):
        clean, _ = raw(clean, make_batch(cfg, dc, s, device="cpu"))

    # checkpoint at 4 (interval=4): crash at 5, resume from 4, replay 4..5
    crashed = {"done": False}

    def make_step():
        def step(state, batch):
            state, m = raw(state, batch)
            if int(state.opt.step) == 5 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("boom")
            return state, m
        return step

    man = CheckpointManager(str(tmp_path), interval=4, keep=2)
    state, hist = run_with_restarts(
        make_step=make_step, init_state=train_init(cfg, params, opt_cfg),
        data_for_step=lambda s: make_batch(cfg, dc, s, device="cpu"),
        n_steps=6, manager=man)
    assert hist["restarts"] == 1
    _assert_states_equal(clean, state)


def test_straggler_monitor_flags_persistent_slowdowns():
    clock = {"t": 0.0}
    times = iter([1.0, 1.0, 1.0, 5.0, 5.0, 1.0])   # EMA ~1.0, two 5s steps

    mon = StragglerMonitor(FaultConfig(straggler_factor=3.0,
                                       straggler_patience=2),
                           clock=lambda: clock["t"])
    fired = []
    for i, dt in enumerate(times):
        mon.start_step()
        clock["t"] += dt
        fired.append(mon.end_step(i))
    assert fired[3] is False and fired[4] is True   # fires on 2nd slow step
    assert len(mon.events) == 2


def test_reshard_state_roundtrip(small):
    """The same logical state on another device and back (the reference's
    elastic restore onto new shardings; one device here)."""
    cfg, params, opt_cfg = small
    state = train_init(cfg, params, opt_cfg)
    moved = reshard_state(state, torch.device("cpu"))
    _assert_states_equal(state, moved)
    meta = reshard_state(state, "meta")
    assert all(x.device.type == "meta" for x in _leaves(meta))


def test_int8_compression_error_feedback():
    transform, init_res = make_int8_compressor()
    g = {"w": torch.tensor(np.random.default_rng(0)
                           .standard_normal((64, 64)), dtype=torch.float32)}
    res = init_res(g)
    total = {"w": torch.zeros_like(g["w"])}
    # accumulated compressed grads converge to accumulated true grads
    for _ in range(20):
        cg, res = transform(g, res)
        total = {"w": total["w"] + cg["w"]}
    want = g["w"] * 20
    err = float((total["w"] - want).abs().max()) / float(want.abs().max())
    assert err < 0.05, err
    # single-shot quantization error is bounded by the int8 step size
    cg, _ = transform(g, init_res(g))
    step = float(g["w"].abs().max()) / 127
    assert float((cg["w"] - g["w"]).abs().max()) <= step * 1.01


def test_int8_compressor_equals_reference():
    """Three steps of error feedback on the same fp32 array: the port's
    compressed gradients and residuals equal the reference's bit for bit
    (``torch.round`` and ``jnp.round`` both round half to even)."""
    from repro.runtime import make_int8_compressor as jax_compressor
    from repro.runtime.compress import quantize_int8 as jax_quantize
    from repro_torch.runtime import quantize_int8
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((33, 17)) * 3).astype(np.float32)
    a[0, :4] = [0.5, -0.5, 1.5, 2.5]            # ties after scaling by 1
    a[0, 4] = 127.0
    jt, jinit = jax_compressor()
    pt, pinit = make_int8_compressor()
    jg, jr = {"w": jnp.asarray(a)}, jinit({"w": jnp.asarray(a)})
    pg, pr = {"w": torch.tensor(a)}, pinit({"w": torch.tensor(a)})
    for _ in range(3):
        jc, jr = jt(jg, jr)
        pc, pr = pt(pg, pr)
        np.testing.assert_array_equal(pc["w"].numpy(), np.asarray(jc["w"]))
        np.testing.assert_array_equal(pr["w"].numpy(), np.asarray(jr["w"]))
    qj, sj = jax_quantize(jnp.asarray(a))
    qp, sp = quantize_int8(torch.tensor(a))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    assert float(sp) == float(sj) and qp.dtype == torch.int8
