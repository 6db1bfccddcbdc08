"""PyTorch port, the config proxies, the capture metadata, the trace
artifacts and the stats formatter against the JAX package (tolerance 0):

* ``core.proxy``: the same proxies and the same YAML text, and
  ``System.from_yaml(...).build(device="cpu")`` runs to the reference's
  ``Stats``;
* ``trace.capture``: ``base_meta`` documents equal the reference's (a
  plain spec, an edited geometry, 2 channels, the hetero system), and a
  capture's metadata equals the reference's capture of the same run;
* ``trace.format``: ``.npz`` and JSON Lines artifacts written by one
  package load in the other with equal columns, metadata and sha256;
* ``engine.format_stats``, ``channel_breakdown`` and ``Stats.summary``
  give the reference's text and dicts (1 channel, 2 channels, hetero).
"""
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import Simulator as JSim                    # noqa: E402
from repro.core import compile_spec as j_compile            # noqa: E402
from repro.core import compile_system as j_system           # noqa: E402
from repro.core import engine as JE                         # noqa: E402
from repro.core import proxy as JP                          # noqa: E402
import repro.trace as JT                                    # noqa: E402

from repro_torch.core import Simulator, compile_spec, compile_system  # noqa
from repro_torch.core import engine as E                    # noqa: E402
from repro_torch.core import proxy as P                     # noqa: E402
import repro_torch.trace as TT                              # noqa: E402

from torch_parity import HETERO_SYSTEM, trace_sha256        # noqa: E402

# the modules (each package's ``trace`` exports a function of their name)
JCap = importlib.import_module("repro.trace.capture")
TCap = importlib.import_module("repro_torch.trace.capture")

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


def _systems(pkg):
    return pkg.System("DDR5", "DDR5_16Gb_x8", "DDR5_4800B",
                      controller=pkg.PROXIES["Controller"](
                          scheduler="FCFS", queue_depth=16),
                      frontend=pkg.PROXIES["Frontend"](interval=2.5,
                                                       read_ratio=0.8),
                      n_cycles=400, timing_overrides={"nCL": 42},
                      channels=2)


def test_proxies_and_yaml_equal_reference():
    assert set(P.PROXIES) == set(JP.PROXIES)
    for name in P.PROXIES:
        assert P.PROXIES[name]._fields == JP.PROXIES[name]._fields
        assert repr(P.PROXIES[name]()) == repr(JP.PROXIES[name]())
    with pytest.raises(TypeError):
        P.PROXIES["Frontend"](no_such_knob=1)
    jsys, tsys = _systems(JP), _systems(P)
    assert tsys.to_dict() == jsys.to_dict()
    assert tsys.to_yaml() == jsys.to_yaml()
    assert P.emit_yaml({"a": [1, 2], "b": {"c": True}, "d": 2.5}) == \
        JP.emit_yaml({"a": [1, 2], "b": {"c": True}, "d": 2.5})
    assert P.parse_yaml(jsys.to_yaml()) == JP.parse_yaml(jsys.to_yaml())


def test_yaml_system_builds_to_reference_stats():
    text = _systems(JP).to_yaml()
    back = P.System.from_yaml(text)
    assert back.to_yaml() == text
    sim = back.build(device="cpu")
    assert isinstance(sim, Simulator) and sim.device.type == "cpu"
    stats = sim.run(back.n_cycles)
    jstats = JP.System.from_yaml(text).build().run(back.n_cycles)
    assert stats.to_dict() == jstats.to_dict()


def _meta_cases():
    edited = lambda pkg: dataclasses.replace(pkg.compile_spec(*DDR4),
                                             rows=2, columns=64)
    return {"plain": (j_compile(*DDR4), compile_spec(*DDR4)),
            "edited": (edited(__import__("repro.core", fromlist=["x"])),
                       edited(__import__("repro_torch.core",
                                         fromlist=["x"]))),
            "two_channels": (j_compile("HBM3", "HBM3_16Gb", "HBM3_5200",
                                       channels=2),
                             compile_spec("HBM3", "HBM3_16Gb", "HBM3_5200",
                                          channels=2)),
            "hetero": (j_system(HETERO_SYSTEM),
                       compile_system(HETERO_SYSTEM))}


@pytest.mark.parametrize("case", sorted(_meta_cases()))
def test_base_meta_equals_reference(case):
    j, t = _meta_cases()[case]
    from repro.core import ControllerConfig as JCtl
    from repro.core import FrontendConfig as JFront
    from repro_torch.core import ControllerConfig, FrontendConfig
    jm = JCap.base_meta(j, controller=JCtl(), frontend=JFront(mapper="x"),
                        interval=2.0, seed=7, label=None)
    tm = TCap.base_meta(t, controller=ControllerConfig(),
                        frontend=FrontendConfig(mapper="x"), interval=2.0,
                        seed=7, label=None)
    assert tm == jm
    # the port rebuilds the system from either package's metadata
    tr = TT.CommandTrace(*(np.zeros(0, np.int32),) * 8, n_cycles=0,
                         cmd_names=[], meta=jm)
    assert TT.spec_fingerprint_hex(tr.compiled_system()) == jm["fingerprint"]


@pytest.fixture(scope="module")
def traces():
    """The same DDR4 and hetero runs captured by both packages."""
    out = {}
    for name, kw, spec_of in (
            ("ddr4", dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                          timing_preset="DDR4_2400R"), lambda s: s.cspec),
            ("hetero", dict(system=HETERO_SYSTEM), lambda s: s.msys)):
        jsim, sim = JSim(**kw), Simulator(**kw, device="cpu")
        _, jd = jsim.run(600, interval=2.0, read_ratio=0.7, trace=True)
        _, td = sim.run(600, interval=2.0, read_ratio=0.7, trace=True)
        meta = dict(interval=2.0, seed=0x1234, label=name)
        out[name] = (JCap.capture(spec_of(jsim), jd,
                                  controller=jsim.controller,
                                  frontend=jsim.frontend, **meta),
                     TCap.capture(spec_of(sim), td,
                                  controller=sim.controller,
                                  frontend=sim.frontend, **meta))
    return out


def _same_trace(a, b):
    fields = TCap.FIELDS + ("group",)
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_cycles, list(a.cmd_names), a.meta) == \
        (b.n_cycles, list(b.cmd_names), b.meta)
    assert TCap.trace_sha256(b, fields) == TCap.trace_sha256(a, fields)


@pytest.mark.parametrize("name", ["ddr4", "hetero"])
def test_capture_metadata_equals_reference(traces, name):
    j, t = traces[name]
    _same_trace(j, t)
    assert trace_sha256(t) == trace_sha256(j)
    assert t.fingerprint == j.fingerprint and t.n_groups == j.n_groups
    assert TT.spec_fingerprint_hex(t.compiled_system()) == t.fingerprint
    for cmd in t.cmd_names:
        assert t.cmd_count(cmd) == j.cmd_count(cmd)


@pytest.mark.parametrize("name", ["ddr4", "hetero"])
def test_artifacts_cross_packages(traces, name, tmp_path):
    j, t = traces[name]
    # .npz: port -> reference and reference -> port
    _same_trace(j, JT.load(TT.save(t, str(tmp_path / "port"))))
    _same_trace(t, TT.load(JT.save(j, str(tmp_path / "ref.npz"))))
    # JSON Lines: hit_ready is not exported, every other column is
    TT.write_jsonl(t, str(tmp_path / "port.jsonl"))
    JT.write_jsonl(j, str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    for back in (JT.read_jsonl(str(tmp_path / "port.jsonl")),
                 TT.read_jsonl(str(tmp_path / "ref.jsonl"))):
        for f in ("clk", "cmd", "bank", "row", "bus", "arrive", "chan",
                  "group"):
            np.testing.assert_array_equal(getattr(back, f), getattr(j, f))
        assert back.meta == j.meta
    assert list(TT.iter_records(t, 100, 300)) == \
        list(JT.iter_records(j, 100, 300))


@pytest.mark.parametrize("case", ["one", "two_channels", "hetero"])
def test_format_stats_and_breakdown_equal_reference(case):
    kw = {"one": dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                      timing_preset="DDR4_2400R"),
          "two_channels": dict(standard="HBM3", org_preset="HBM3_16Gb",
                               timing_preset="HBM3_5200", channels=2),
          "hetero": dict(system=HETERO_SYSTEM)}[case]
    jsim, sim = JSim(**kw), Simulator(**kw, device="cpu")
    js = jsim.run(400, interval=2.0, read_ratio=0.7)
    s = sim.run(400, interval=2.0, read_ratio=0.7)
    spec = sim.cspec if sim.cspec is not None else sim.msys
    jspec = jsim.cspec if case != "hetero" else jsim.msys
    assert E.format_stats(s) == JE.format_stats(js)
    assert E.format_stats(s, spec) == JE.format_stats(js, jspec)
    assert s.summary(spec) == js.summary(jspec)
    assert E.channel_breakdown(spec, s) == JE.channel_breakdown(jspec, js)
