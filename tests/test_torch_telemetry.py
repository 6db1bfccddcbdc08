"""PyTorch port, windowed telemetry: ``Simulator.run(n, telemetry=W)``
gives the JAX package's ``Telemetry`` element for element (tolerance 0),
sums back to its own ``Stats`` (``Telemetry.check``), leaves the ``Stats``
as they are without telemetry, and ``make_run(points=P,
telemetry_window=W)`` snapshots every point at its own clock as the
reference's vmapped run does (``test_torch_telemetry_batch.py``);
multi-channel and system cases are in ``test_torch_telemetry_system.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import Simulator as JSim                   # noqa: E402
from repro.telemetry import write_jsonl as j_write_jsonl   # noqa: E402
from repro.trace import capture as j_capture                # noqa: E402

from repro_torch import telemetry as T                     # noqa: E402
from repro_torch.core import Simulator                     # noqa: E402
from repro_torch.trace import capture                      # noqa: E402

from torch_parity import (TELEMETRY_CASES as CASES,        # noqa: E402
                          assert_telemetry_equal, check_telemetry_case,
                          telemetry_pair, trace_sha256)


@pytest.mark.parametrize("case", ["ddr4_ragged", "exact", "short"])
def test_windows_equal_reference(case):
    check_telemetry_case(case)


def test_fast_forward_off_equals_on():
    kw, n, W, run = CASES["ddr4_ragged"]
    js, jt, s, t, sim = telemetry_pair(kw, n, W, run, fast_forward=False)
    on = Simulator(**kw, device="cpu").run(n, telemetry=W, **run)[1]
    assert_telemetry_equal(jt, t)
    assert_telemetry_equal(on, t)
    assert sim.host_syncs == 0 and s.scan_steps == n


def test_trace_with_telemetry():
    kw, n, W, run = CASES["exact"]
    jsim = JSim(**kw)
    js, jd, jt = jsim.run(n, trace=True, telemetry=W, **run)
    sim = Simulator(**kw, device="cpu")
    s, dense, t = sim.run(n, trace=True, telemetry=W, **run)
    assert s.to_dict() == js.to_dict()
    assert_telemetry_equal(jt, t)
    assert trace_sha256(capture(sim.cspec, dense)) \
        == trace_sha256(j_capture(jsim.cspec, jd))


def test_artifacts_round_trip(tmp_path):
    kw, _, _, run = CASES["hetero"]
    s, t = Simulator(**kw, device="cpu").run(500, telemetry=300, **run)
    back = T.load(T.save(t, str(tmp_path / "telem.npz")))
    assert_telemetry_equal(t, back)
    back.check(s)
    assert T.write_jsonl(t, str(tmp_path / "telem.jsonl")) == t.n_windows
    lines = (tmp_path / "telem.jsonl").read_text().splitlines()
    assert len(lines) == t.n_windows
    j_write_jsonl(t, str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "ref.jsonl").read_text().splitlines() == lines
    assert "windows of 300 cycles" in t.summary()
