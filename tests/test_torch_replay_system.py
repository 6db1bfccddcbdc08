"""PyTorch port, trace replay on a memory system: a DDR5 + CXL-DDR4@40
system's captured trace goes through each package's
``to_replay(deps=True)`` (equal fingerprints) and replays, probes on, to
the reference's ``Stats.to_dict()``, every ``per_group`` leaf and
command-stream sha256 (over ``FIELDS + ("group",)``), tolerance 0."""
import pytest

pytest.importorskip("torch")

from repro.core import FrontendConfig as JFront            # noqa: E402
from repro.core import Simulator as JSim                   # noqa: E402
from repro.core import compile_system as j_compile_system  # noqa: E402
from repro.trace import capture as j_capture                # noqa: E402
from repro.trace import to_replay as j_to_replay            # noqa: E402

from repro_torch.core import FrontendConfig, Simulator     # noqa: E402
from repro_torch.core import compile_system                # noqa: E402
from repro_torch.trace import FIELDS, capture, to_replay   # noqa: E402
from repro_torch.trace import trace_sha256                 # noqa: E402

from torch_parity import TELEMETRY_HETERO, stats_doc       # noqa: E402

SYSTEM = TELEMETRY_HETERO


def test_system_replay_with_deps_equals_reference():
    src = dict(interval=6.0, read_ratio=0.5, seed=9, trace=True)
    jmsys, msys = j_compile_system(SYSTEM), compile_system(SYSTEM)
    _, jd = JSim(system=jmsys).run(1000, **src)
    _, dense = Simulator(system=msys, device="cpu").run(1000, **src)
    jr = j_to_replay(j_capture(jmsys, jd), jmsys, deps=True)
    pr = to_replay(capture(msys, dense), msys, deps=True)
    assert pr.fingerprint == jr.fingerprint
    assert set(pr.chan.tolist()) == {0, 1} and (pr.dep >= 0).any()

    run = dict(trace=True, seed=9)
    jsim = JSim(system=jmsys, frontend=JFront(pattern="trace"), replay=jr)
    js, jd = jsim.run(2000, **run)
    sim = Simulator(system=msys, frontend=FrontendConfig(pattern="trace"),
                    replay=pr, device="cpu")
    s, dense = sim.run(2000, **run)
    assert stats_doc(s) == stats_doc(js)
    fields = FIELDS + ("group",)
    assert trace_sha256(capture(msys, dense), fields) \
        == trace_sha256(j_capture(jmsys, jd), fields)
    assert s.probe_cnt > 0 and all(int(ch.reads_done.sum()) > 0
                                   for ch in s.per_group)
