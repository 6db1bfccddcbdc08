"""The port's spans (``repro_torch.telemetry.spans``) on the CPU under
``torch.profiler``: their names and counts per train step and per
prompt, their parents and shared ids, their host ranges in the
profiler's events, nothing recorded and no marker in the autograd graph
with the profiler off, bit-identical training with it on, and
``Profiler.span``; and ``serve_batch``'s device syncs."""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig
from repro_torch.serve import step as S
from repro_torch.telemetry import Profiler, spans
from repro_torch.train import make_train_step, train_init
from repro_torch.train.step import loss_fn

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
#: three 512-position chunks of the loss head (1,100 padded to 1,536)
SEQ = 1100


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def remainder_cfg():
    """One checkpointed group of two layers and one remainder layer."""
    return dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               n_layers=3, block_pattern=("attn", "attn"))


def train(cfg, traced: bool, microbatch: int = 1, steps: int = 2):
    """``steps`` steps from the same weights and rows, each under its own
    profiler session when ``traced``; -> ``(state, metrics, the last
    session's records, its profiler)``."""
    state = train_init(cfg, init_params(cfg, 3, "cpu"), OPT)
    step = make_train_step(cfg, OPT, microbatch=microbatch)
    dc = DataConfig(seq_len=SEQ, global_batch=2)
    prof = None
    for i in range(steps):
        batch = make_batch(cfg, dc, step=i, device="cpu")
        if traced:
            with cpu_profile() as prof:
                state, met = step(state, batch)
            recs = spans.records()
        else:
            state, met = step(state, batch)
    return state, met, (recs if traced else None), prof


def counts(recs) -> dict:
    return dict(collections.Counter(r["name"] for r in recs))


def host_counts(prof, names) -> dict:
    c = collections.Counter(ev.name() for ev in
                            prof.profiler.kineto_results.events())
    return {n: c[n] for n in names}


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_spans_counts_parents_ids_and_host_ranges(microbatch):
    cfg = remainder_cfg()
    _, _, recs, prof = train(cfg, True, microbatch)
    G = cfg.n_groups() + 1                  # the groups and the remainder
    assert counts(recs) == {"lm.group.fwd": G * microbatch,
                            "lm.group.bwd": G * microbatch,
                            "lm.group.recompute": cfg.n_groups() * microbatch,
                            "lm.head.fwd": 3 * microbatch,
                            "lm.head.bwd": microbatch, "train.adamw": 1}
    assert host_counts(prof, counts(recs)) == counts(recs)
    # the last of two steps (numbered from 0 in the step's closure)
    assert {r["step"] for r in recs} == {1}
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        want = "lm.group.bwd" if r["name"] == "lm.group.recompute" else None
        parent = by_id[r["parent"]] if r["parent"] is not None else None
        assert (parent and parent["name"]) == want, r
        if want:
            assert (parent["group"], parent["microbatch"]) == \
                (r["group"], r["microbatch"])
        if r["name"] == "train.adamw":
            assert r["microbatch"] is None
        else:
            assert r["microbatch"] in range(microbatch)
        assert r["device_s"] >= 0 and r["num_device_alloc"] == 0
    assert sorted(r["chunk"] for r in recs if r["name"] == "lm.head.fwd") \
        == sorted(list(range(3)) * microbatch)
    assert sorted(r["group"] for r in recs if r["name"] == "lm.group.bwd") \
        == sorted(list(range(G)) * microbatch)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_profiler_changes_no_value_of_the_step(microbatch):
    cfg = get_arch("qwen3-4b").reduced()
    s0, m0, _, _ = train(cfg, False, microbatch)
    s1, m1, _, _ = train(cfg, True, microbatch)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    p1 = dict(s1.params.named_parameters())
    for name, p in s0.params.named_parameters():
        assert torch.equal(p, p1[name]), name
        assert torch.equal(s0.opt.m[name], s1.opt.m[name]), name
        assert torch.equal(s0.opt.v[name], s1.opt.v[name]), name
    assert torch.equal(s0.opt.step, s1.opt.step)


def graph_nodes(t) -> set:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def test_profiler_off_records_nothing_and_adds_no_marker():
    cfg = remainder_cfg()
    params = init_params(cfg, 3, "cpu").requires_grad_(True)
    batch = make_batch(cfg, DataConfig(seq_len=64, global_batch=2), step=0,
                       device="cpu")
    with cpu_profile():
        on, _ = loss_fn(cfg, params, batch)
    assert "_MarkBackward" in graph_nodes(on)
    assert spans.records()
    spans.clear()
    assert spans.records() == []
    off, _ = loss_fn(cfg, params, batch)
    assert "_MarkBackward" not in graph_nodes(off)
    torch.autograd.grad(off, list(params.parameters()), allow_unused=True)
    assert spans.records() == []


@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-2b"])
def test_prefill_spans_per_prompt(arch):
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, 5, "cpu")
    T, n = 40, 2
    prefill = S.make_prefill_step(cfg, cache_len=T)
    pos = torch.arange(T, dtype=torch.int32)[None]
    gen = torch.Generator().manual_seed(0)
    with cpu_profile() as prof:
        for _ in range(n):
            toks = torch.randint(0, cfg.vocab, (1, T), generator=gen)
            logits, _ = prefill(params, M.Batch(tokens=toks, positions=pos))
            S.greedy_sample(logits[:, -1])
    recs = spans.records()
    L = cfg.n_layers
    attn = sum(k in ("attn", "local_attn") for k in cfg.pattern_layers())
    assert counts(recs) == {"lm.layer.fwd": n * L,
                            "lm.prefill.kv_state": n * attn,
                            "lm.last_logits": n, "serve.sample": n}
    assert host_counts(prof, counts(recs)) == counts(recs)
    assert all(r["parent"] is None for r in recs)
    for i in range(n):
        mine = [r for r in recs if r["request"] == i]
        assert counts(mine) == {k: v // n for k, v in counts(recs).items()}
        assert sorted(r["layer"] for r in mine
                      if r["name"] == "lm.layer.fwd") == list(range(L))


def test_profiler_span_opens_the_same_span():
    prof = Profiler()
    with cpu_profile() as tp:
        with prof.span("sweep"):
            torch.ones(4).sum()
    recs = spans.records()
    assert [r["name"] for r in recs] == ["sweep"]
    assert host_counts(tp, ["sweep"]) == {"sweep": 1}
    assert prof.report()["spans"]["sweep"]["calls"] == 1


def test_serve_batch_syncs_only_for_timings(monkeypatch):
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_params(cfg, 2, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    calls = []
    real = S._sync
    monkeypatch.setattr(S, "_sync", lambda dev: calls.append(dev) or
                        real(dev))
    tok, first = S.serve_batch(cfg, params, prompts, 3, device="cpu")
    assert calls == [] and tok.shape == (2, 3)
    timings = {}
    tok2, first2 = S.serve_batch(cfg, params, prompts, 3, device="cpu",
                                 timings=timings)
    assert len(calls) == 3 and set(timings) == {"prefill_s", "decode_s"}
    assert torch.equal(tok, tok2) and torch.equal(first, first2)
