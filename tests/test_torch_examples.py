"""PyTorch port, the examples (``examples/torch/*.py``): each runs its
reference example's session through ``repro_torch`` alone, on the CPU
only when asked (``--device cpu``).  Here each runs in-process at a tiny
size; what it returns, and what it prints, equals the port's library
run of the same recipe (``torch_parity.session_doc``), which the other
``test_torch_*`` files hold bit for bit against the JAX package.  The
full-size sessions are held to ``tests/torch_examples_stats.json`` on
the card (``chip_smoke.py`` phase 18)."""
import pytest

import torch_parity as tp

#: tiny sessions: a few hundred cycles, a 2x2 sweep grid, the reduced
#: model with the prompt cut to 8
TINY = dict(
    quickstart=dict(cycles=200),
    extend_standard=dict(),
    hetero_system=dict(cycles=200, sweep_cycles=150, links=[40, 80]),
    multichannel=dict(cycles=200, requests=300),
    dse_sweep=dict(cycles=200, intervals=[8.0, 2.0], read_ratios=[1.0],
                   trace_cycles=150),
    visualize_trace=dict(standard="LPDDR5", cycles=200),
    serve_lm=dict(variant="reduced", seed=0, batch=4, prompt_len=8,
                  max_new=16),
    memsys_aware_roofline=dict(cycles=300),
)
#: what each example prints: the reference example's sections and names
PRINTS = dict(
    quickstart=("=== YAML equivalent", "=== simulation ===",
                "=== probe API ===", "RD on closed bank:", "RD at nRCD:"),
    extend_standard=("nVRR = 674 cycles", "ACT at nVRR-1: timing_OK=False",
                     "ACT at nVRR:   timing_OK=True",
                     "VRR extension behaves correctly."),
    hetero_system=("memory system: DDR5x2+DDR4x2@80", "audit: ",
                   "link-latency sweep"),
    multichannel=("aggregate: ", "  ch3: ", "derived ",
                  "onto 2-channel DDR4; per-channel reads: "),
    dse_sweep=("=== 4 design points, 2 compiled programs",
               "peak_frac=", "curve artifact written to",
               "command-trace visualizer written to"),
    visualize_trace=("commands captured -> ", "visualizer -> ",
                     "open in a browser"),
    serve_lm=("arch=llama3.2-1b-reduced device=cpu", "sample: "),
    memsys_aware_roofline=("achieved/peak from the simulated "
                           "latency-throughput knee = ",),
)


def test_every_example_is_covered():
    assert set(TINY) == set(PRINTS) == set(tp.EXAMPLES)
    assert set(tp.EXAMPLE_RUNS) == set(tp.EXAMPLES)


@pytest.mark.parametrize("name", tp.EXAMPLES)
def test_example_equals_the_library(name, tmp_path, capsys):
    run = TINY[name]
    res = tp.load_example(name).main(tp.example_argv(name, run, "cpu",
                                                     str(tmp_path)))
    out = capsys.readouterr().out
    for piece in PRINTS[name]:
        assert piece in out, (name, piece)
    got = tp.port_example_doc(name, res)
    want = tp.session_doc(name, run, top="repro_torch")
    assert got == want
    if name == "quickstart":
        assert res["stats"].summary(res["sim"].cspec) in out
    if name in ("hetero_system", "dse_sweep"):
        table = (res["sweep"] if name == "hetero_system"
                 else res["result"]).to_table()
        assert table in out
    if name in ("dse_sweep", "visualize_trace"):
        assert sorted(p.name for p in tmp_path.iterdir()) == (
            ["dse_sweep_example.json", "dse_sweep_example.npz",
             "hbm3_trace.html"] if name == "dse_sweep" else
            ["lpddr5_trace.html", "lpddr5_trace.npz"])


def test_roofline_example_reads_the_dry_run(tmp_path, capsys):
    """Its memory term: the dry run's per-device bytes over the H100's
    HBM bandwidth, naive and at the simulated achieved fraction."""
    import json
    from repro_torch.launch.mesh import HBM_BW
    rec = dict(arch="llama3.2-1b", cost=dict(bytes_accessed=2.5e12))
    (tmp_path / "llama3.2-1b__train_4k__16x16.json").write_text(
        json.dumps(rec))
    res = tp.load_example("memsys_aware_roofline").main(
        ["--device", "cpu", "--cycles", "300", "--results", str(tmp_path)])
    assert "llama3.2-1b" in capsys.readouterr().out
    (row,) = res["rows"]
    assert row["t_naive"] == 2.5e12 / HBM_BW
    assert row["t_achieved"] == 2.5e12 / (HBM_BW * res["fraction"])
    assert 0 < res["fraction"] <= 1


@pytest.mark.parametrize("name", ["quickstart", "serve_lm"])
def test_example_needs_the_card_unless_asked(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.load_example(name).main([])
