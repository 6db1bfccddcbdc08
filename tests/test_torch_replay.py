"""PyTorch port, trace replay (``FrontendConfig(pattern="trace")``,
``Simulator(replay=...)``): the port's ``ReplayStream.from_addresses``
and ``trace.to_replay(deps=True)`` give the reference's streams (equal
fingerprints), and replaying a stream gives the JAX package's
``Stats.to_dict()`` and command-stream sha256 (tolerance 0): paced by the
captured arrival clocks with read-after-write / write-after-read holds,
at the streaming pace, with fast-forward on and off.  A bad stream raises
the reference's four ``ValueError``s.  Memory systems and ``run_batch``
are in ``test_torch_replay_system.py``."""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import FrontendConfig as JFront            # noqa: E402
from repro.core import ReplayStream as JStream             # noqa: E402
from repro.core import Simulator as JSim                   # noqa: E402
from repro.trace import capture as j_capture                # noqa: E402
from repro.trace import to_replay as j_to_replay            # noqa: E402

from repro_torch.core import FrontendConfig, ReplayStream  # noqa: E402
from repro_torch.core import Simulator                     # noqa: E402
from repro_torch.trace import capture, to_replay           # noqa: E402

from torch_parity import trace_sha256                      # noqa: E402

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


@functools.lru_cache(maxsize=None)
def streams(deps=True):
    """The reference's and the port's ``to_replay`` of one source run of
    each package (DDR4, 1,200 cycles, interval 16, read ratio 0.5)."""
    src = dict(interval=16.0, read_ratio=0.5, seed=3, trace=True)
    js = JSim(*DDR4)
    _, jd = js.run(1200, **src)
    sim = Simulator(*DDR4, device="cpu")
    _, dense = sim.run(1200, **src)
    return (j_to_replay(j_capture(js.cspec, jd), js.cspec, deps=deps),
            to_replay(capture(sim.cspec, dense), sim.cspec, deps=deps))


def replay_pair(jstream, stream, n, fast_forward=True, probes=False,
                **run):
    """Replay each package's stream through its own DDR4 simulator:
    ``(reference stats, its sha256, port stats, its sha256, simulator)``."""
    jsim = JSim(*DDR4, frontend=JFront(pattern="trace", probes=probes),
                replay=jstream, fast_forward=fast_forward)
    js, jd = jsim.run(n, trace=True, **run)
    sim = Simulator(*DDR4, frontend=FrontendConfig(pattern="trace",
                                                   probes=probes),
                    replay=stream, fast_forward=fast_forward, device="cpu")
    s, dense = sim.run(n, trace=True, **run)
    return (js, trace_sha256(j_capture(jsim.cspec, jd)), s,
            trace_sha256(capture(sim.cspec, dense)), sim)


def test_to_replay_fingerprint_equals_reference():
    for deps in (True, False):
        jr, pr = streams(deps)
        assert pr.fingerprint == jr.fingerprint
        for f in ("chan", "sub", "row", "col", "is_write", "arrive"):
            np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
    jr, pr = streams(True)
    np.testing.assert_array_equal(pr.dep, jr.dep)
    assert (pr.dep >= 0).any() and (np.diff(pr.arrive) >= 0).all()


def test_from_addresses_fingerprint_equals_reference():
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 30, 300) & ~63
    wr = rng.random(300) < 0.3
    js, ps = JSim(*DDR4).cspec, Simulator(*DDR4, device="cpu").cspec
    for order in ("RoBaRaCoCh", "RoCoBaRaCh"):
        a = JStream.from_addresses(js, addrs, wr, order=order)
        b = ReplayStream.from_addresses(ps, addrs, wr, order=order)
        assert a.fingerprint == b.fingerprint and len(b) == 300


@pytest.mark.parametrize("fast_forward", [True, False])
def test_paced_replay_with_deps_equals_reference(fast_forward):
    jr, pr = streams(True)
    js, jsha, s, sha, sim = replay_pair(jr, pr, 3000, fast_forward, seed=3)
    assert s.to_dict() == js.to_dict()
    assert sha == jsha
    assert s.reads_done + s.writes_done > 0
    if fast_forward:
        assert s.skipped_cycles > 0 and sim.host_syncs == s.scan_steps


def test_unpaced_replay_with_probes_equals_reference():
    rng = np.random.default_rng(11)
    addrs = rng.integers(0, 1 << 28, 400) & ~63
    wr = rng.random(400) < 0.4
    jstream = JStream.from_addresses(JSim(*DDR4).cspec, addrs, wr)
    stream = ReplayStream.from_addresses(
        Simulator(*DDR4, device="cpu").cspec, addrs, wr)
    js, jsha, s, sha, _ = replay_pair(jstream, stream, 2000, probes=True,
                                      interval=3.0, seed=5)
    assert s.to_dict() == js.to_dict() and sha == jsha
    assert s.probe_cnt > 0 and s.writes_done > 0


def _bad(**cols):
    base = dict(chan=np.zeros(4, np.int32), sub=np.zeros((4, 3), np.int32),
                row=np.arange(4, dtype=np.int32),
                col=np.zeros(4, np.int32), is_write=np.zeros(4, np.int32))
    base.update(cols)
    return ReplayStream(**base)


@pytest.mark.parametrize("stream,match", [
    (_bad(chan=np.zeros(0, np.int32), sub=np.zeros((0, 3), np.int32),
          row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
          is_write=np.zeros(0, np.int32)), "empty"),
    (_bad(arrive=np.asarray([0, 5, 3, 9], np.int32)), "non-decreasing"),
    (_bad(chan=np.asarray([0, 1, 0, 0], np.int32)), "channel 1"),
    (_bad(sub=np.zeros((4, 2), np.int32)), "sub columns"),
])
def test_bad_streams_raise(stream, match):
    sim = Simulator(*DDR4, frontend=FrontendConfig(pattern="trace"),
                    replay=stream, device="cpu")
    with pytest.raises(ValueError, match=match):
        sim.run(10)


def test_trace_pattern_needs_a_stream():
    with pytest.raises(ValueError, match="ReplayStream"):
        Simulator(*DDR4, frontend=FrontendConfig(pattern="trace"),
                  device="cpu").run(10)
    # without the stream source the pattern is never read
    stats = Simulator(*DDR4, frontend=FrontendConfig(
        pattern="trace", stream=False), device="cpu").run(50)
    assert stats.probe_cnt > 0 and int(stats.reads_done) == stats.probe_cnt


def test_stream_is_a_frozen_value():
    _, pr = streams(True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        pr.chan = pr.row
    assert len(pr) == len(pr.chan) and len(pr.fingerprint) == 16


def test_replay_and_telemetry_read_back_only_the_loop_sync():
    """Neither the replay gather nor the telemetry gauges and snapshots
    read a value back to the host: the loop's one packed sync per
    iteration stays the only read (the snapshots come back once, after
    the loop, as a copy)."""
    from torch.profiler import ProfilerActivity, profile
    _, pr = streams(True)
    sim = Simulator(*DDR4, frontend=FrontendConfig(pattern="trace"),
                    replay=pr, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats, telem = sim.run(120, telemetry=40, seed=3)
    reads = [e.key for e in prof.events()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert reads == [] and telem.n_windows == 3
    assert sim.host_syncs == stats.scan_steps
