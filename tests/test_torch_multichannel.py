"""PyTorch port, multi-channel systems (``Simulator(channels=N)``).

* The refresh stagger: channel ``c`` of ``C`` starts with ``last_ref =
  -(c * nREFI // C)``, exactly the reference's initial state, and all
  channels in phase with ``refresh_stagger=False``.
* The ``DDR4@2ch`` golden command stream (``mapper="RoBaRaCoCh"``,
  ``refresh_stagger=False``) through the port's ``capture`` (``[T, C,
  2]`` arrays, the ``chan`` column), fast-forward on and off.
* the three mapper orders at 2 channels (``Stats`` and command stream);
  4-channel DDR4 and HBM3 ``Stats`` are in
  ``test_torch_multichannel_stats.py``.
* ``tests/torch_multichannel_stats.json`` holds the reference's ``Stats``
  of ``examples/multichannel.py``'s session (HBM3, 4 channels,
  ``RoBaRaCoCh``, 10,000 cycles, interval 0.5, read ratio 0.9), which
  ``chip_smoke.py`` holds the port to on the card; it is regenerated here
  with the JAX ``Simulator`` so it cannot drift.
Tolerance 0 throughout."""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.core import ControllerConfig as JCfg             # noqa: E402
from repro.core import FrontendConfig as JFcfg              # noqa: E402
from repro.core import Simulator as JSim                    # noqa: E402
from repro.core import compile as JCmp                      # noqa: E402
from repro.core import engine as JE                         # noqa: E402
from repro.trace import capture as j_capture                 # noqa: E402

from repro_torch.core import ControllerConfig, Simulator, compile_spec  # noqa: E402,E501
from repro_torch.core import controller as TC               # noqa: E402
from repro_torch.core.addrmap import MAPPERS                # noqa: E402
from repro_torch.trace import capture                       # noqa: E402

from torch_parity import (GOLDEN, MULTI_FIXTURE, TRIO,       # noqa: E402
                          multichannel_fixture, trace_sha256)


def _jax_initial_last_ref(std, org, tim, channels, stagger):
    """The reference's initial ``last_ref`` (C, U): its engine's
    ``_init_state``, taken from the run function's closure."""
    cspec = JCmp.compile_spec(std, org, tim, channels=channels)
    run = JE.make_run(cspec, JCfg(refresh_stagger=stagger), JFcfg(), 10,
                      False)
    init = inspect.getclosurevars(run).nonlocals["_init_state"]
    return np.asarray(init(jnp.uint32(1)).gs[0].cs.dev.last_ref)


@pytest.mark.parametrize("std,org,tim,channels", [
    (*TRIO[0], 2), (*TRIO[0], 4), (*TRIO[1], 3), (*TRIO[2], 4)])
@pytest.mark.parametrize("stagger", [True, False])
def test_refresh_stagger_matches_reference(std, org, tim, channels, stagger):
    cspec = compile_spec(std, org, tim, channels=channels)
    for points in (1, 3):
        cs = TC.init_ctrl_state(cspec, 8, channels, "cpu", stagger, points)
        want = _jax_initial_last_ref(std, org, tim, channels, stagger)
        got = cs.dev.last_ref.numpy().reshape((points,) + want.shape)
        for p in range(points):
            np.testing.assert_array_equal(got[p], want)
    if stagger:
        assert (want[1:] < 0).all() and (want[0] == 0).all()
    else:
        assert (want == 0).all()


@pytest.mark.parametrize("fast_forward", [True, False])
def test_two_channel_golden_stream(fast_forward):
    from repro_torch.trace import trace_sha256 as port_sha
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    mapper="RoBaRaCoCh", device="cpu",
                    fast_forward=fast_forward,
                    controller=ControllerConfig(refresh_stagger=False))
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    assert tuple(dense.cmd.shape) == (3000, 2, 2)
    tr = capture(sim.cspec, dense)
    want = GOLDEN["DDR4@2ch"]
    assert len(tr) == want["n"]
    assert trace_sha256(tr) == port_sha(tr) == want["sha256"]
    assert set(tr.chan.tolist()) == {0, 1}
    if not fast_forward:
        assert stats.scan_steps == 3000


@pytest.mark.parametrize("mapper", MAPPERS)
def test_mapper_orders_at_two_channels(mapper):
    std, org, tim = TRIO[0]
    kw = dict(channels=2, mapper=mapper)
    sim = Simulator(std, org, tim, device="cpu", **kw)
    stats, dense = sim.run(800, interval=1.0, read_ratio=0.8, trace=True)
    jsim = JSim(std, org, tim, **kw)
    jstats, jdense = jsim.run(800, interval=1.0, read_ratio=0.8, trace=True)
    assert stats.to_dict() == jstats.to_dict()
    assert trace_sha256(capture(sim.cspec, dense)) \
        == trace_sha256(j_capture(jsim.cspec, jdense))


def test_capture_rejects_a_trace_of_the_wrong_rank():
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2)
    flat = torch.full((10, 2), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2-channel"):
        capture(cspec, (flat, flat, flat, flat, flat.bool()))


def test_multichannel_fixture_is_current():
    doc = json.load(open(MULTI_FIXTURE))
    assert doc == json.loads(json.dumps(multichannel_fixture()))
    assert doc["run"] == dict(
        standard="HBM3", org_preset="HBM3_16Gb", timing_preset="HBM3_5200",
        channels=4, mapper="RoBaRaCoCh", n_cycles=10_000, interval=0.5,
        read_ratio=0.9, seed=0x1234)
