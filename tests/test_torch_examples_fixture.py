"""PyTorch port, the fixture of the examples and of ``chip_smoke.py``
phase 18: ``tests/torch_examples_stats.json`` holds the reference
examples' results at their own sizes (``torch_parity.EXAMPLE_RUNS``),
``tests/torch_examples_serve.npz`` the reduced llama3.2-1b's reference
weights, prompts, tokens and logits.

* Its recipes are the constants of ``tests/torch_parity.py`` that the
  tests and ``chip_smoke.py`` share, and the sessions an earlier fixture
  holds are read from it (the DDR5 README session, the hetero session,
  the 4-channel HBM3 session).
* Its cheap parts are current: the reference, run again here, gives the
  same VRR extension and the same LPDDR5 trace session; the port serves
  the fixture's weights into the reference's tokens (but at a near tie of
  the reference's logits, the rule of ``chip_smoke.py`` phases 7 and
  18).
Both are rewritten by ``tests/torch_parity.py --write-example-fixtures``.
"""
import importlib.util
import json
import os

import numpy as np

import torch_parity as tp

DOC = json.load(open(tp.EXAMPLES_FIXTURE))


def test_fixture_recipes_are_the_shared_constants():
    assert list(DOC) == list(tp.EXAMPLES)
    for name in tp.EXAMPLES:
        assert DOC[name]["run"] == tp.EXAMPLE_RUNS[name], name
    assert {n for n in DOC if "reused" in DOC[n]} == set(tp.EXAMPLE_REUSE)
    # the reused sessions are the ones the earlier fixtures ran
    main = json.load(open(tp.MAIN_FIXTURE))["run"]
    assert (main["n_cycles"], main["interval"], main["read_ratio"]) == (
        tp.EXAMPLE_RUNS["quickstart"]["cycles"], 2.0, 0.8)
    het = json.load(open(tp.HETERO_FIXTURE))
    assert het["system"] == tp.HETERO_SYSTEM
    assert het["session"]["run"]["n_cycles"] == \
        tp.EXAMPLE_RUNS["hetero_system"]["cycles"]
    multi = json.load(open(tp.MULTI_FIXTURE))["run"]
    assert multi["n_cycles"] == tp.EXAMPLE_RUNS["multichannel"]["cycles"]
    # phase 18 runs these very objects
    smoke = _chip_smoke()
    assert smoke.parity() is tp
    assert tuple(smoke.EXAMPLE_PHASES) == tp.EXAMPLES


def test_reference_side_is_current():
    for name in ("extend_standard", "visualize_trace"):
        got = tp.session_doc(name, tp.EXAMPLE_RUNS[name])
        assert got == tp.example_reference_doc(name), name


def _chip_smoke():
    path = os.path.join(os.path.dirname(tp.HERE), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_port_serves_the_reference_tokens(capsys):
    # the example at its own size on the CPU, held as phase 18 holds it on
    # the card: logits within the decode-parity tolerance of the
    # reference's, greedy tokens equal but at a near tie
    from repro_torch.launch.serve import load_params
    z = np.load(tp.EXAMPLES_SERVE)
    run = json.loads(str(z["run"]))
    assert run == tp.EXAMPLE_RUNS["serve_lm"]
    want = tp.example_reference_doc("serve_lm")
    assert want == dict(tokens=z["tokens"].tolist(),
                        first=z["first"].tolist())
    res = tp.load_example("serve_lm").main(
        tp.example_argv("serve_lm", run, "cpu", "unused"))
    assert "sample: " in capsys.readouterr().out
    tie = _chip_smoke().greedy_check(
        res["cfg"], load_params(tp.EXAMPLES_SERVE, res["cfg"], "cpu"),
        res["prompts"], res["first"], res["tokens"], z, "cpu")
    # a near tie may end a request's comparison; most tokens are compared
    assert tie["compared"] >= 0.75 * z["tokens"].size
