"""The per-layer metrics that read the program's spans
(``program_spans.py``, ``yardstick/spans.py``): each reader on a
synthetic trace and synthetic records, and each driver's traced tiny run
on the CPU, where every reader of its cell gives a value."""
from __future__ import annotations

import pytest

import program_spans
from conftest import BENCH, tiny_run
from yardstick import spans
from yardstick import trace as tr
from yardstick.trace import Trace

MS = 1_000_000
TRAIN = ("head_share.train", "adamw_share.train", "adamw_launches.train",
         "recompute_share.train")
PREFILL = ("kv_state_share.prefill", "device_allocs.prefill")


def read(name: str, t):
    from run import load_module
    return load_module(BENCH / "metrics" / f"{name}.py").read(t)


def rec(name, device_s, parent=None, allocs=0, retries=0):
    return {"id": None, "name": name, "parent": parent, "step": 0,
            "microbatch": 0, "request": None, "chunk": None, "group": None,
            "layer": None, "device_s": device_s, "num_device_alloc": allocs,
            "num_device_free": 0, "num_alloc_retries": retries}


def synthetic(kind: str, records) -> Trace:
    """A 10-ms window, busy 8 ms, two steps or requests; the optimizer's
    host ranges hold three of the five launch calls."""
    device = [("k", 0, 4 * MS), ("k", 5 * MS, 9 * MS)]
    host = [("perfbench.step", 0, 10 * MS),
            ("train.adamw", 1 * MS, 2 * MS),
            ("cudaLaunchKernel", 1 * MS + 10, 1 * MS + 20),
            ("cuLaunchKernelEx", 1 * MS + 30, 1 * MS + 40),
            ("cudaLaunchKernel", 3 * MS, 3 * MS + 10),
            ("train.adamw", 6 * MS, 7 * MS),
            ("cudaMemcpyAsync", 6 * MS + 5, 6 * MS + 9),
            ("cudaLaunchKernel", 6 * MS + 10, 6 * MS + 20),
            ("cudaLaunchKernel", 8 * MS, 8 * MS + 10)]
    t = Trace(t0=0, t1=10 * MS, device=device, host=host,
              info={"kind": kind, "steps": 2, "requests": 2}, peak=None)
    t.spans = records
    return t


def test_train_readers_on_synthetic_spans():
    t = synthetic("train", [rec("lm.head.fwd", 0.002),
                            rec("lm.head.bwd", 0.003),
                            rec("lm.group.bwd", 0.002),
                            rec("lm.group.recompute", 0.0005, parent=3),
                            rec("train.adamw", 0.001)])
    assert read("head_share.train", t) == pytest.approx(50.0)
    assert read("adamw_share.train", t) == pytest.approx(10.0)
    assert read("recompute_share.train", t) == pytest.approx(5.0)
    # 3 launch calls inside the two optimizer ranges, over 2 steps
    assert read("adamw_launches.train", t) == pytest.approx(1.5)
    assert spans.busy_share(t, t.spans, ("lm.head.fwd", "lm.head.bwd")) \
        == pytest.approx(62.5)
    for name in PREFILL:
        assert read(name, t) is None


def test_prefill_readers_on_synthetic_spans():
    t = synthetic("prefill", [
        rec("lm.layer.fwd", 0.003, allocs=2), rec("lm.prefill.kv_state",
                                                  0.0015, retries=1),
        rec("lm.last_logits", 0.001, allocs=1), rec("serve.sample", 0.0001),
        rec("nested", 0.0001, parent=0, allocs=50)])
    assert read("kv_state_share.prefill", t) == pytest.approx(15.0)
    # the outermost spans only: (2 + 1 + 1) over 2 requests
    assert read("device_allocs.prefill", t) == pytest.approx(2.0)
    for name in TRAIN:
        assert read(name, t) is None


def test_readers_give_nothing_without_the_programs_spans():
    for kind, names in (("train", TRAIN), ("prefill", PREFILL)):
        t = synthetic(kind, [])
        t.host = [h for h in t.host if h[0] != "train.adamw"]
        for name in names:
            assert read(name, t) is None, name


def cpu_reduce(prof, info, peak) -> Trace:
    """``trace.reduce`` for a CPU run, which records no device work."""
    host, window = [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        if ev.name() == tr.WINDOW_SPAN:
            window = (s, s + ev.duration_ns())
        else:
            host.append((ev.name(), s, s + ev.duration_ns()))
    host.sort(key=lambda x: x[1])
    return Trace(t0=window[0], t1=window[1], device=[], host=host,
                 info=info, peak=peak)


@pytest.mark.parametrize("kind,names", [("train", TRAIN),
                                        ("prefill", PREFILL)])
def test_traced_tiny_run_reads_every_span_metric(drivers, monkeypatch, kind,
                                                 names):
    monkeypatch.setattr(tr, "reduce", cpu_reduce)
    ctx = tiny_run(kind, 17)
    ctx.traced = True
    res = drivers[kind].run(ctx)
    t = ctx.trace
    t.info = res["info"]
    got = {name: read(name, t) for name in names}
    assert all(v is not None for v in got.values()), got
    assert all(v >= 0 for v in got.values()), got
    if kind == "prefill":
        assert got["device_allocs.prefill"] == 0      # no allocator here
        n = t.info["requests"]
        # request 0 was the warm-up
        assert {r["request"] for r in program_spans.records(t)} == \
            set(range(1, n + 1))
    else:
        assert got["head_share.train"] > 0
        steps = {r["step"] for r in program_spans.records(t)}
        assert len(steps) == t.info["steps"]
