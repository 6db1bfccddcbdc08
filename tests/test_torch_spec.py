"""PyTorch port, spec layer and package boundaries.

Every ``CompiledSpec`` field of the port equals the reference's for all
12 registered standards at every (org, timing) preset pair; the address
mappers agree; the port imports neither ``jax`` nor ``repro``; its entry
points default to CUDA and raise without it; and every option the port
does not cover yet raises instead of being ignored."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import addrmap as JA                     # noqa: E402
from repro.core import compile as JC                     # noqa: E402
from repro.core import standards as _jstd                # noqa: E402,F401
from repro.core.spec import all_standards as jax_all     # noqa: E402

from repro_torch.core import addrmap as TA               # noqa: E402
from repro_torch.core import compile as TC               # noqa: E402
from repro_torch.core.spec import all_standards as torch_all  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

STANDARDS = sorted(jax_all())


def _eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


def test_same_registered_standards():
    from repro.dse.spec import DEFAULT_SYSTEMS
    from repro_torch.core.standards import DEFAULT_SYSTEMS as port_defaults
    assert STANDARDS == sorted(torch_all())
    assert len(STANDARDS) == 12
    assert port_defaults == DEFAULT_SYSTEMS


@pytest.mark.parametrize("std", STANDARDS)
def test_compiled_spec_fields_equal_reference(std):
    cls = jax_all()[std]
    pairs = [(o, t) for o in cls.org_presets for t in cls.timing_presets]
    assert pairs
    for org, tim in pairs:
        want = JC.compile_spec(std, org, tim)
        got = TC.compile_spec(std, org, tim)
        for f in dataclasses.fields(JC.CompiledSpec):
            assert _eq(getattr(want, f.name), getattr(got, f.name)), \
                (std, org, tim, f.name)


@pytest.mark.parametrize("order", JA.MAPPERS)
def test_address_mapper_matches_reference(order):
    assert TA.MAPPERS == JA.MAPPERS
    rng = np.random.default_rng(sum(map(ord, order)))
    for std in ("DDR4", "DDR5", "LPDDR5", "HBM3", "GDDR7"):
        cls = jax_all()[std]
        org, tim = next(iter(cls.org_presets)), next(iter(cls.timing_presets))
        jm = JA.AddressMapper(JC.compile_spec(std, org, tim), order)
        tm = TA.AddressMapper(TC.compile_spec(std, org, tim), order)
        assert jm.layout == tm.layout and jm.tx_bits == tm.tx_bits
        addr = rng.integers(0, 1 << 34, 512, dtype=np.int64)
        jf, tf = jm.map(addr), tm.map(addr)
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(jf[k], tf[k])
        np.testing.assert_array_equal(jm.encode(jf), tm.encode(tf))
        for a, b in zip(jm.to_chan_sub_row_col(addr),
                        tm.to_chan_sub_row_col(addr)):
            np.testing.assert_array_equal(a, b)
        # the port's decode also runs on torch tensors, as the engine does
        t = TA.decode_fields(tm.layout, torch.as_tensor(addr >> tm.tx_bits))
        for k in jf:
            np.testing.assert_array_equal(jf[k], t[k].numpy())


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax_and_no_reference():
    files = list(_port_files())
    assert len(files) > 15
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_fresh_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.trace, repro_torch.kernels.readiness\n"
        "import repro_torch.kernels.build, repro_torch.analysis\n"
        "import repro_torch.dse, repro_torch.dse.sweep\n"
        "import repro_torch.core.proxy, repro_torch.telemetry\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_simulator_defaults_to_cuda_and_raises_without_it():
    from repro_torch.core import Simulator
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cuda")
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu")
    assert sim.device.type == "cpu"


def _sim(**kw):
    from repro_torch.core import Simulator
    return Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu", **kw)


def _sim_system(groups):
    from repro_torch.core import Simulator
    return Simulator(system=groups, device="cpu")


def _unported():
    return {
        "channel_shard": lambda: _sim(channel_shard=2),
    }


@pytest.mark.parametrize("option", sorted(_unported()))
def test_unported_option_raises(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _unported()[option]()


def _ported():
    """Options that raised until they were ported, each run at a tiny
    size: ``channels=2`` builds a 2-channel run, ``run_batch`` returns
    ``(pts, stats)`` with a leading point axis, ``system=`` runs a
    composition of spec groups, the BlockHammer, PRAC and user
    predicates configure the controller, ``telemetry=W`` returns windows
    that sum to the run's ``Stats``, ``pattern="trace"`` replays a
    ``replay=`` stream, and ``compile_spec(lint="warn"|"error")`` lints
    (an error-severity finding raises with ``"error"``)."""
    from repro_torch.core import (ControllerConfig, FrontendConfig,
                                  ReplayStream)

    def system():
        sim = _sim_system([("DDR4", "DDR4_8Gb_x8", "DDR4_2400R"),
                           ("DDR5", "DDR5_16Gb_x8", "DDR5_4800B", 1, 20)])
        stats = sim.run(40, interval=2.0)
        assert sim.msys.n_groups == 2 and len(stats.per_group) == 2
        assert tuple(stats.per_channel.cmd_counts.shape) == (
            2, sim.msys.n_cmds)

    def predicate(**cfg):
        def check():
            stats = _sim(controller=ControllerConfig(**cfg)).run(
                40, interval=2.0)
            assert stats.cycles == 40
        return check

    def channels():
        sim = _sim(channels=2)
        stats = sim.run(40, interval=2.0)
        assert sim.cspec.n_channels == 2
        assert tuple(stats.per_channel.reads_done.shape) == (2,)
        assert stats.cycles == 40

    def run_batch():
        pts, stats = _sim(channels=2).run_batch(40, [2.0, 8.0], [1.0, 0.5])
        assert pts == [(2.0, 1.0), (2.0, 0.5), (8.0, 1.0), (8.0, 0.5)]
        assert tuple(stats.reads_done.shape) == (4,)
        assert tuple(stats.per_channel.cmd_counts.shape[:2]) == (4, 2)
        assert list(stats.cycles) == [40] * 4
        assert stats.point(3).to_dict()["cycles"] == 40
    def telemetry():
        stats, telem = _sim().run(100, interval=2.0, telemetry=50)
        assert list(telem.t_end) == [50, 100]
        telem.check(stats)

    def replay():
        stream = ReplayStream.from_addresses(
            _sim().cspec, np.arange(16) * 64, np.arange(16) % 2)
        stats = _sim(frontend=FrontendConfig(pattern="trace", probes=False),
                     replay=stream).run(200, interval=2.0)
        assert int(stats.reads_done) > 0 and stats.cycles == 200

    def lint(mode):
        def check():
            clean = TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R",
                                    lint=mode)
            assert clean.n_banks == 16
            bad = lambda: TC.compile_spec("DDR4", "DDR4_8Gb_x8",
                                          "DDR4_2400R", {"nRC": 1},
                                          lint=mode)
            if mode == "error":
                with pytest.raises(ValueError, match="trc-decomposition"):
                    bad()
            else:
                assert bad().timings["nRC"] == 1
        return check

    def trace_pattern():
        assert FrontendConfig(pattern="trace").pattern == "trace"
        with pytest.raises(ValueError, match="ReplayStream"):
            _sim(frontend=FrontendConfig(pattern="trace")).run(10)
    return {"channels": channels, "run_batch": run_batch, "system": system,
            "telemetry": telemetry, "replay": replay,
            "trace_pattern": trace_pattern,
            "lint_warn": lint("warn"), "lint_error": lint("error"),
            "blockhammer": predicate(blockhammer_threshold=8),
            "prac": predicate(prac_threshold=8),
            "extra_predicates": predicate(extra_predicates=(
                lambda cspec, ctx: ctx.cand_cmd >= 0,))}


@pytest.mark.parametrize("option", sorted(_ported()))
def test_ported_option_runs(option):
    _ported()[option]()


def test_channels_build_one_lane_per_channel():
    """``channels=N`` builds N channels of controller state and staggers
    their refresh epochs (ROADMAP queue 1 item 6)."""
    from repro_torch.core import controller as TCtl
    sim = _sim(channels=4)
    assert sim.cspec.n_channels == 4
    cs = TCtl.init_ctrl_state(sim.cspec, 8, 4, "cpu", True)
    assert tuple(cs.dev.last_ref.shape) == (4, sim.cspec.n_refresh_units)
    assert cs.dev.last_ref[0].eq(0).all()
    assert (cs.dev.last_ref[1:] < 0).all()


def test_lint_env_gate_raises_and_off_compiles(monkeypatch):
    monkeypatch.setenv("REPRO_SPEC_LINT", "error")
    with pytest.raises(ValueError, match="spec lint failed"):
        TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", {"nRC": 1})
    assert TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R").n_banks == 16
    monkeypatch.setenv("REPRO_SPEC_LINT", "off")
    assert TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R").n_banks == 16
    with pytest.raises(ValueError):
        TC.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", lint="loud")
