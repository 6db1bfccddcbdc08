"""The comparison that decides ``correct`` fails what it must: the fp8
control in the program's place, and a run whose timed path is broken
underneath (a step that returns its state unchanged, half of the batch
left out, a served token altered, a cache left unfilled).  Tiny widths on
the CPU, past the harness's look for a card."""
from __future__ import annotations

import json

import pytest
import torch

import calibrate
from conftest import ROOT, TINY, TINY_QK, tiny_run
from yardstick import compare

SEEDS = (3, 4294967311, 2**31 + 7)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _judge(ctx, numbers):
    return compare.judge(numbers, ctx.cell.own["limits"])[0]


@pytest.mark.parametrize("model", [TINY, TINY_QK], ids=lambda m: m.name)
@pytest.mark.parametrize("seed", SEEDS)
def test_train_program_passes_and_control_fails(model, seed):
    ctx = tiny_run("train", seed, model=model)
    got = dict(calibrate.train_readings(ctx, control=True))
    assert _judge(ctx, got["program"]), got["program"]
    assert not _judge(ctx, got["control_fp8"]), got["control_fp8"]
    assert not _judge(ctx, got["fault_half_batch"])


@pytest.mark.parametrize("model", [TINY, TINY_QK], ids=lambda m: m.name)
@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_program_passes_and_control_fails(model, seed):
    ctx = tiny_run("prefill", seed, model=model)
    got = dict(calibrate.prefill_readings(ctx, control=True))
    assert _judge(ctx, got["program"]), got["program"]
    assert not _judge(ctx, got["control_fp8"]), got["control_fp8"]
    assert not _judge(ctx, got["fault_token"]), got["fault_token"]


def _run(drivers, kind, cell, seed=5):
    from run import report
    ctx = tiny_run(kind, seed, model=TINY_QK)
    ctx.cell.name = cell
    out = report(BENCH, ctx, drivers[kind].run(ctx), "cpu", None)
    return out


def test_sound_runs_come_out_correct(drivers):
    assert _run(drivers, "train", "glm4-9b.train-8k")["correct"]
    assert _run(drivers, "prefill", "qwen3-4b.prefill-32k")["correct"]


def test_step_returning_its_state_unchanged_is_caught(drivers, monkeypatch):
    import repro_torch.train.step as S
    real = S.make_train_step

    def broken(*a, **k):
        step = real(*a, **k)

        def same(state, batch):
            return state, step(state, batch)[1]
        return same
    monkeypatch.setattr(S, "make_train_step", broken)
    out = _run(drivers, "train", "glm4-9b.train-8k")
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(drivers, monkeypatch):
    import repro_torch.train.step as S
    from repro_torch.models.model import Batch
    real = S.make_train_step

    def broken(*a, **k):
        step = real(*a, **k)

        def half(state, b):
            n = b.tokens.shape[0] // 2
            return step(state, Batch(tokens=b.tokens[:n],
                                     positions=b.positions[:n],
                                     labels=b.labels[:n]))
        return half
    monkeypatch.setattr(S, "make_train_step", broken)
    assert not _run(drivers, "train", "glm4-9b.train-8k")["correct"]


def test_altered_token_is_caught(drivers, monkeypatch):
    import repro_torch.serve.step as S
    real = S.greedy_sample
    monkeypatch.setattr(S, "greedy_sample",
                        lambda logits: (real(logits) + 1) % TINY_QK.vocab)
    out = _run(drivers, "prefill", "qwen3-4b.prefill-32k")
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > 0.5


def test_cache_left_unfilled_is_caught(drivers, monkeypatch):
    import repro_torch.serve.step as S
    real = S.make_prefill_step

    def broken(*a, **k):
        step = real(*a, **k)

        def empty(params, batch):
            logits, states = step(params, batch)
            return logits, [type(s)(*(torch.zeros_like(t) for t in s))
                            for s in states]
        return empty
    monkeypatch.setattr(S, "make_prefill_step", broken)
    out = _run(drivers, "prefill", "qwen3-4b.prefill-32k")
    assert not out["correct"]
    assert out["checks"]["kv_err"]["value"] == pytest.approx(1.0)
