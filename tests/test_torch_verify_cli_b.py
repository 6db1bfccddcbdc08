"""PyTorch port, the CLIs in subprocesses against the reference's CLIs
(``tests/torch_verify_stats.json``; see ``test_torch_verify_cli_a.py``).
This file: ``python -m repro_torch.analysis`` (``spec`` with overrides and
a JSON report, ``diff``; ``trace``, the reference's JAX lint, exits
non-zero naming its ROADMAP item) and ``python -m repro_torch.verify``
(``diff`` against the pinned fixtures; ``explore --loosen ACT:RD
--expect-counterexample``, whose artifact equals the reference's).
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))["cli"]


@pytest.mark.parametrize("name", ["analysis_spec", "analysis_diff",
                                  "verify_diff", "verify_loosen"])
def test_cli_equals_the_references(name, tmp_path):
    got = tp.port_cli(name, str(tmp_path))
    assert got == DOC[name]
    assert got["rc"] == 0


def test_analysis_trace_names_its_roadmap_item():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(tp.HERE), "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "trace"], env=env, capture_output=True, text=True,
                         timeout=120)
    # the stub that named ROADMAP item 17 is now the host-sync lint
    # itself: clean on the shipped tree
    assert out.returncode == 0, out.stdout + out.stderr
    assert "host-sync lint: clean" in out.stdout
