"""PyTorch port, property-based invariants on full multi-channel and
heterogeneous systems on the CPU: HBM3 over 2 channels under the
row-conflict stream (4,000 cycles, nREFI 400, seed 3) and the DDR5 +
CXL-attached DDR4 system (link latency 40) under the bursty stream
(6,000 cycles, seed 11, per-group audit and refresh deadlines) give the
reference's ``PropertyReport``s exactly (``tests/torch_verify_stats.json``).
"""
import json

import pytest

pytest.importorskip("torch")

from repro_torch import verify                             # noqa: E402
from repro_torch.core import ControllerConfig              # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))["properties"]


@pytest.mark.parametrize("key", ["HBM3x2/row_conflict", "hetero/bursty"])
def test_system_properties_equal_the_references(key):
    rep = tp.property_run(verify, ControllerConfig, key, device="cpu")
    assert tp.property_doc(rep) == DOC[key]
    assert rep.ok and rep.info["served"] > 10


def test_verify_properties_runs_on_cuda_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.property_run(verify, ControllerConfig, "DDR4/bursty")
