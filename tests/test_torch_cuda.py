"""PyTorch port on the card: the CUDA readiness kernel and the engine on
``cuda``.  Every test here needs an NVIDIA GPU and ``nvcc`` and skips
without them; on the card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with PyTorch alone.  The kernel is held bit for bit against its plain
PyTorch version on device states after random command histories, at
timestamps below and above 2**24; the engine on ``cuda`` reproduces a
golden command stream and launches the kernel."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ControllerConfig, Simulator, compile_spec  # noqa: E402,E501
from repro_torch.core import device as D                    # noqa: E402
from repro_torch.core.standards import DEFAULT_SYSTEMS      # noqa: E402
from repro_torch.kernels import readiness as R              # noqa: E402
from repro_torch.trace import capture, trace_sha256         # noqa: E402

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
SYSTEMS = [(s, o, t) for s, (o, t) in sorted(DEFAULT_SYSTEMS.items())]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card: "
                    "python -m pytest -q -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _random_state(cspec, dp, device, seed, clk0, channels=1, steps=80):
    rng = np.random.default_rng(seed)
    st = D.init_state(cspec, channels, device)
    counts = [int(c) for c in cspec.level_counts[1:]]
    clk = clk0
    for _ in range(steps):
        t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        st = D.issue(cspec, dp, st,
                     t(rng.integers(0, cspec.n_cmds, channels)),
                     t(np.stack([rng.integers(0, c, channels)
                                 for c in counts], 1)),
                     t(rng.integers(0, 64, channels)), clk,
                     torch.as_tensor(rng.random(channels) < 0.9,
                                     device=device))
        clk += int(rng.integers(1, 8))
    return st


@pytest.mark.parametrize("std,org,tim", SYSTEMS)
def test_kernel_equals_plain_version(cuda, std, org, tim):
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, cuda, channels=3)
    tab = dp.tables.ready
    for seed, clk0 in ((1, 0), (2, (1 << 24) + 777)):
        st = _random_state(cspec, dp, cuda, seed, clk0, channels=3)
        before = R.launch_count
        got = R.readiness_table(tab, st.last_issue, st.win_ring)
        assert R.launch_count == before + 1
        want = R.readiness_table_plain(tab, st.last_issue, st.win_ring)
        torch.cuda.synchronize()
        assert got.shape == (3, cspec.n_cmds, cspec.n_banks)
        assert torch.equal(got, want), (std, clk0)


def test_kernel_rejects_wrong_dtype(cuda):
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = D.dyn_params(cspec, cuda)
    st = D.init_state(cspec, 1, cuda)
    with pytest.raises(ValueError):
        R.readiness_table(dp.tables.ready, st.last_issue.long(),
                          st.win_ring)


def test_golden_stream_on_cuda(cuda):
    golden = json.load(open(os.path.join(HERE, "trace",
                                         "golden_hashes.json")))
    sim = Simulator("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400",
                    controller=ControllerConfig(scheduler="FRFCFS"))
    assert sim.device.type == "cuda"
    before = R.launch_count
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    assert R.launch_count > before
    tr = capture(sim.cspec, dense)
    assert len(tr) == golden["LPDDR5"]["n"]
    assert trace_sha256(tr) == golden["LPDDR5"]["sha256"]
    assert sim.host_syncs == stats.scan_steps
