"""PyTorch port, the CLIs in subprocesses with ``--device cpu`` against
the reference's CLIs (``tests/torch_verify_stats.json``): the exit code,
the standard output (the temporary directory masked) and every artifact —
traces and telemetry by content, pages and JSON Lines byte for byte, lint
reports as JSON — equal the reference's.  This file: ``python -m
repro_torch.trace`` (one DDR4 channel; the DDR5 + CXL-DDR4 system, per
group audited) and ``python -m repro_torch.telemetry``.
"""
import json

import pytest

pytest.importorskip("torch")

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))["cli"]


@pytest.mark.parametrize("name", ["trace", "trace_hetero", "telemetry"])
def test_cli_equals_the_references(name, tmp_path):
    got = tp.port_cli(name, str(tmp_path))
    assert got == DOC[name]
    assert got["rc"] == 0
