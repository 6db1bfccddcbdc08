"""The harness's pieces on the CPU: the result line's keys, the trace's
reduction and the per-layer readers, the reference's attention, what the
harness imports, and the seeded traffic."""
from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, TINY_QK, tiny_run
from yardstick import tokens
from yardstick.trace import Trace

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_result_line_has_the_contracts_keys(drivers):
    from run import cell_metrics, report
    ctx = tiny_run("prefill", 11, model=TINY_QK)
    ctx.cell.name = "qwen3-4b.prefill-32k"
    out = report(BENCHMARK, ctx, drivers["prefill"].run(ctx), "cpu", None)
    assert set(out) == LINE_KEYS and list(out)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    e2e = {e["name"] for e in cell_metrics(BENCHMARK, ctx.cell.name)[0]}
    assert set(out["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["checks"]) == set(ctx.cell.own["limits"])
    json.dumps(out)


def _trace(kind: str) -> Trace:
    ms = 1_000_000
    device = [("flash_fwd_sm90_kernel<128>", 0, 4 * ms),
              ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", 5 * ms, 7 * ms),
              ("nvjet_sss_128x64_64x4_1x2_h_bz_NNT", 7 * ms, 8 * ms),
              ("flash_bwd_dq_kernel<128>", 8 * ms, 9 * ms),
              ("Memset (Device)", 9 * ms, 10 * ms)]
    host = [("perfbench.step", 0, 10 * ms), ("aten::mm", 4 * ms, 5 * ms),
            ("cudaMalloc", 4 * ms + 10, 5 * ms - 10)]
    info = {"kind": kind, "steps": 2, "requests": 2, "model_flops": 1e12,
            "attn_fwd": (2.0e9, 1e6), "attn_bwd": (5e9, 2e6),
            "attn_bwd_calls": 1}
    peak = {"bf16_flops": 1e12, "fp32_flops": 1e11, "hbm_bytes": 1e11}
    return Trace(t0=0, t1=10 * ms, device=device, host=host, info=info,
                 peak=peak)


def test_trace_busy_idle_and_breakdown():
    t = _trace("train")
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.009)
    assert t.idle_gaps() == [(4_000_000, 5_000_000)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["flash_fwd_sm90_kernel<128>", 0.004]
    assert b["idle_gaps"] == [["step/aten::mm > cudaMalloc", 0.001]]
    assert len(t.kernels()) == 4


def test_per_layer_readers_on_a_synthetic_trace():
    from run import load_module
    read = lambda name, t: load_module(
        BENCH / "metrics" / f"{name}.py").read(t)
    t = _trace("train")
    assert read("mfu.train", t) == pytest.approx(100 * 1e12 / (0.01 * 1e12))
    assert read("mfu.prefill", t) is None
    # one forward launch of 2e9 operations at 1e12/s: 2 ms of its 4 ms
    assert read("flash_fwd_roofline.train", t) == pytest.approx(50.0)
    assert read("flash_bwd_roofline.train", t) == pytest.approx(500.0)
    assert read("bf16_gemm_share.train", t) == pytest.approx(200 / 9)
    assert read("fp32_gemm_share.train", t) == pytest.approx(100 / 9)
    assert read("launches_per_step.train", t) == pytest.approx(2.0)
    assert read("idle_share.train", t) == pytest.approx(10.0)
    assert read("idle_share.prefill", t) is None
    t.peak = None
    assert read("mfu.train", t) is None


def test_every_per_layer_metric_has_a_reader():
    from run import load_module
    for m in BENCHMARK["per_layer"]:
        assert callable(load_module(BENCH / "metrics"
                                    / f"{m['name']}.py").read)


def test_reference_attention_matches_plain_softmax():
    from reference import dense_gqa as ref
    torch.manual_seed(0)
    B, T, H, Hkv, D = 2, 37, 4, 2, 8
    q = torch.randn(B, T, H, D, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, T, Hkv, D, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, T, Hkv, D, dtype=torch.float64, requires_grad=True)
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    out = ref.attention(*f32, "fp32", blk=16)
    kr, vr = (t.repeat_interleave(H // Hkv, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / D ** 0.5
    s = s.masked_fill(torch.ones(T, T).triu(1).bool(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    assert torch.allclose(out.double(), want, atol=1e-5)
    g = torch.randn_like(want)
    out.backward(g.float())
    want.backward(g)
    for a, b in zip(f32, (q, k, v)):
        assert torch.allclose(a.grad.double(), b.grad, atol=1e-4)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for path in (BENCH / sub).glob("*.py"):
            bad = _imports(path) & {"repro_torch", "repro", "jax", "jaxlib",
                                    "flax", "program"}
            assert not bad, (path.name, bad)


def test_tiny_runs_load_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r},"
        f" {str(ROOT / 'src')!r}]\n"
        "from conftest import tiny_run, TINY_QK\n"
        "from run import load_module, forbidden_modules, BENCH_DIR\n"
        "for k in ('train', 'prefill'):\n"
        "    d = load_module(BENCH_DIR / 'drivers' / (k + '.py'))\n"
        "    assert d.run(tiny_run(k, 9, model=TINY_QK))['numbers']\n"
        "print(forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_traffic_is_a_function_of_the_seed():
    a = tokens.train_rows(2**31 + 5, 3, 2, 64, 1000, 1.3, "cpu")
    b = tokens.train_rows(2**31 + 5, 3, 2, 64, 1000, 1.3, "cpu")
    c = tokens.train_rows(2**31 + 5, 4, 2, 64, 1000, 1.3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0][0], a[0][1])         # every row its own
    assert torch.equal(a[0][:, 1:], a[1][:, :-1])    # labels are next tokens
    assert int(a[0].min()) >= 0 and int(a[0].max()) < 1000


def test_config_file_names_the_reference_and_the_family():
    from yardstick import model as wm
    for name in ("glm4-9b", "qwen3-4b"):
        m = wm.load(name)
        assert (m.reference, m.family) == ("dense_gqa", "dense")
    ctx = tiny_run("prefill", 1, model=TINY_QK)
    assert callable(ctx.reference().prefill)
    ctx.model = dataclasses.replace(TINY_QK, reference="no_such_reference")
    with pytest.raises(ModuleNotFoundError):
        ctx.reference()


def test_checked_request_keeps_only_the_sketch_of_its_cache(drivers):
    from yardstick import compare
    drv = drivers["prefill"]
    ctx = tiny_run("prefill", 21, model=TINY_QK)
    serve, signs = drv.setup(ctx)
    served, kept = [], {}
    for i in range(3):
        drv.serve_one(serve, i, [1], served, kept, signs)
    assert len(served) == 3 and list(kept) == [1]
    width = TINY_QK.n_kv_heads * TINY_QK.head_dim
    assert all(t.shape == (compare.SKETCH_ROWS, width)
               for kv in kept[1] for t in kv)
    numbers = drv.check(ctx, served, kept)["program"]
    assert compare_ok(ctx, numbers)


@pytest.mark.parametrize("where", ["one position", "spread"])
def test_sketch_keeps_the_relative_error(where):
    from yardstick import compare
    gen = torch.Generator().manual_seed(3)
    k = torch.randn(1, 512, 2, 16, generator=gen)
    bad = k.clone()
    if where == "one position":
        bad[0, 100] += 3.0
    else:
        bad += 0.05 * torch.randn(k.shape, generator=gen)
    signs = compare.sketch_matrix(2**31 + 3, 512, "cpu")
    full = compare.rel_err(bad, k)
    got = compare.rel_err(compare.sketch(signs, bad),
                          compare.sketch(signs, k))
    assert got == pytest.approx(full, rel=0.15)
    assert compare.rel_err(compare.sketch(signs, k),
                           compare.sketch(signs, k)) == 0.0


def test_checked_request_past_the_close_is_served_but_not_counted(
        drivers, monkeypatch):
    drv = drivers["prefill"]
    ctx = tiny_run("prefill", 22, model=TINY_QK, seconds=0.0)
    monkeypatch.setattr(drv, "picks", lambda ctx: [2])
    res = drv.run(ctx)
    assert res["attempted"] == 0 and res["e2e"]["prefill_tok_s"] == 0
    assert compare_ok(ctx, res["numbers"])


def test_control_token_gap_is_read_at_every_position():
    from reference import dense_gqa as ref
    from yardstick import model as wm
    m = TINY_QK
    weights = wm.make_weights(m, 5, "cpu")
    toks = tokens.prompt(5, 0, 96, m.vocab, 1.3, "cpu")
    last, h = ref.prefill(m, weights, toks)
    assert h.shape == (96, m.d_model)
    head = ref.head_weight(m, weights).float()
    assert torch.allclose(last, h[-1] @ head, atol=1e-5)
    drv_gap = _prefill_driver().widest_gap
    assert drv_gap(ref, m, weights, h, h, blk=32) >= 0.0
    far = h + 0.5 * torch.randn(h.shape, generator=torch.Generator()
                                .manual_seed(0))
    assert drv_gap(ref, m, weights, h, far, blk=32) > 0.0


def _prefill_driver():
    from run import load_module
    return load_module(BENCH / "drivers" / "prefill.py")


def compare_ok(ctx, numbers) -> bool:
    from yardstick import compare
    return compare.judge(numbers, ctx.cell.own["limits"])[0]
