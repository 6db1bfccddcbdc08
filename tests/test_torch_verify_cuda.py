"""PyTorch port, the validation workflow's device path on the card
(``-m cuda``; skips without one):

* the exploration transition (``verify.explore._Step``: queue insert,
  fused controller-step launch, readiness-table launch) on ``cuda``
  against the plain one on the CPU on the same states and injections —
  next state, events and earliest-ready tables bit for bit — over random
  walks of 64 lanes through the 9 smoke specs and a loosened spec, with
  one fused and one table launch per transition and no plain step;
* the readiness table at 64 tiny lanes against
  ``earliest_ready_table_plain``;
* the DDR4 ``b2-q2`` exploration on ``cuda`` equal to the fixture's.

    python -m pytest -q -m cuda tests/test_torch_verify_cuda.py
"""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing as T                       # noqa: E402
from repro_torch import verify                             # noqa: E402
from repro_torch.core import ControllerConfig              # noqa: E402
from repro_torch.core import controller as C               # noqa: E402
from repro_torch.core import device as D                   # noqa: E402
from repro_torch.kernels import controller_step as KS      # noqa: E402
from repro_torch.kernels import readiness as R             # noqa: E402

import torch_parity as tp                                  # noqa: E402

pytestmark = pytest.mark.cuda

X = importlib.import_module("repro_torch.verify.explore")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card: "
                    "python -m pytest -q -m cuda "
                    "tests/test_torch_verify_cuda.py)")
    return torch.device("cuda")


WALKS = tp.explore_walk_specs(X, ControllerConfig)


@pytest.mark.parametrize("key,cspec,ccfg", WALKS, ids=[w[0] for w in WALKS])
def test_transition_on_cuda_equals_the_plain_one(cuda, key, cspec, ccfg):
    for d, launches, diff in T.explore_walk(cspec, ccfg, cuda,
                                            seed=len(key)):
        assert launches == (1, 1, 0), (key, d)
        assert diff == {}, (key, d)


def test_readiness_table_at_64_tiny_lanes(cuda):
    for std in tp.VERIFY_STANDARDS:
        cspec = X.tiny_spec(std, banks=4, fast=True)
        dp = D.dyn_params(cspec, cuda)
        rng = np.random.default_rng(3)
        st = D.init_state(cspec, 64, cuda)
        li = torch.as_tensor(rng.integers(-2, 200, st.last_issue.shape),
                             dtype=torch.int32, device=cuda)
        li = torch.where(li < 0, torch.full_like(li, D.NEG), li)
        wr = torch.as_tensor(rng.integers(0, 200, st.win_ring.shape),
                             dtype=torch.int32, device=cuda)
        st = st._replace(last_issue=li, win_ring=wr)
        before = R.launch_count
        got = D.earliest_ready_table(cspec, dp, st)
        assert R.launch_count == before + 1
        want = D.earliest_ready_table_plain(cspec, dp, st)
        torch.cuda.synchronize()
        assert got.shape == (64, cspec.n_cmds, cspec.n_banks)
        assert torch.equal(got, want), std


def test_exploration_on_cuda_equals_the_fixture(cuda):
    doc = json.load(open(tp.VERIFY_FIXTURE))["smoke"]["DDR4/b2-q2"]
    config = next(c for c in X.SMOKE_CONFIGS if c[0] == "b2-q2")
    f0, t0, p0 = KS.launch_count, R.launch_count, C.plain_calls
    res = verify.smoke(("DDR4",), (config,), device=cuda)
    assert tp.explore_doc(res[("DDR4", "b2-q2")]) == doc
    fused, tables = KS.launch_count - f0, R.launch_count - t0
    assert fused == tables > 0 and C.plain_calls == p0
