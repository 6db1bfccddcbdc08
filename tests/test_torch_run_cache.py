"""PyTorch port, the run cache and the engine's helpers against the JAX
package (tolerance 0):

* ``spec_fingerprint``, ``system_fingerprint`` and
  ``trace.spec_fingerprint_hex`` equal the reference's for every default
  system, a timing override, a 2-channel spec and a composition;
* ``_freeze`` equates predicates built by separate factory calls;
* ``Simulator.run`` goes through ``RUN_CACHE``: a second instance and a
  sweep of the load knobs build nothing new, an edited spec gets a fresh
  build, and the entries of one system keep one set of DynParams;
* ``telemetry.Profiler`` spans and cache deltas and ``profile_run``
  behave as the reference's.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import Simulator as JSim                    # noqa: E402
from repro.core import compile_spec as j_compile            # noqa: E402
from repro.core import compile_system as j_system           # noqa: E402
from repro.core import engine as JE                         # noqa: E402
from repro.trace.capture import spec_fingerprint_hex as j_hex  # noqa: E402

from repro_torch import telemetry as T                      # noqa: E402
from repro_torch.core import Simulator, compile_spec, compile_system  # noqa
from repro_torch.core import engine as E                    # noqa: E402
from repro_torch.trace import spec_fingerprint_hex          # noqa: E402

from torch_parity import HETERO_SYSTEM, default_systems     # noqa: E402

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


def _specs():
    out = {std: ((std, org, tim), {}) for std, (org, tim)
           in default_systems().items()}
    out["DDR4+nRCD"] = (DDR4, dict(timing_overrides={"nRCD": 20}))
    out["HBM3@2ch"] = (("HBM3", "HBM3_16Gb", "HBM3_5200"),
                       dict(channels=2))
    return out


@pytest.mark.parametrize("name", sorted(_specs()))
def test_fingerprints_equal_reference(name):
    args, kw = _specs()[name]
    j, t = j_compile(*args, **kw), compile_spec(*args, **kw)
    assert E.spec_fingerprint(t) == JE.spec_fingerprint(j)
    assert E.system_fingerprint(t) == JE.system_fingerprint(j)
    assert spec_fingerprint_hex(t) == j_hex(j)
    if name == "DDR4":
        assert spec_fingerprint_hex(t) == "1d1803da20dce416"


def test_system_fingerprint_of_a_composition_equals_reference():
    j, t = j_system(HETERO_SYSTEM), compile_system(HETERO_SYSTEM)
    assert E.system_fingerprint(t) == JE.system_fingerprint(j)
    assert spec_fingerprint_hex(t) == j_hex(j)
    # a 1-group zero-link system keys as its bare spec
    one = compile_system([dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                               timing_preset="DDR4_2400R")])
    assert spec_fingerprint_hex(one) == "1d1803da20dce416"


def _make_pred(threshold):
    def pred(cspec, ctx, t=threshold):
        return ctx.cand_cmd != t
    return pred


def test_freeze_equates_factory_built_predicates():
    a, b, c = _make_pred(3), _make_pred(3), _make_pred(4)
    assert E._freeze(a) == E._freeze(b) != E._freeze(c)
    assert E._freeze(a) == JE._freeze(a)
    from repro_torch.core import ControllerConfig
    ka = E.run_key(compile_spec(*DDR4), ControllerConfig(
        extra_predicates=(a,)), Simulator(*DDR4, device="cpu").frontend,
        100, False, False, device="cpu")
    kb = E.run_key(compile_spec(*DDR4), ControllerConfig(
        extra_predicates=(b,)), Simulator(*DDR4, device="cpu").frontend,
        100, False, False, device="cpu")
    assert ka == kb


def test_simulator_runs_reuse_one_cache_entry():
    E.RUN_CACHE.clear()
    a = Simulator(*DDR4, device="cpu")
    builds = E.TRACE_COUNT
    sa = a.run(300, interval=32.0, read_ratio=1.0)
    assert (E.RUN_CACHE.misses, E.TRACE_COUNT) == (1, builds + 1)
    entry = next(iter(E.RUN_CACHE._runs.values()))
    dps = entry.dps
    # a second instance and the load knobs: hits, nothing built
    sb = Simulator(*DDR4, device="cpu").run(300, interval=32.0,
                                            read_ratio=1.0)
    for iv, rr in ((16.0, 1.0), (4.0, 0.5), (1.0, 0.8)):
        a.run(300, interval=iv, read_ratio=rr, seed=7)
    assert (E.RUN_CACHE.misses, E.RUN_CACHE.hits) == (1, 4)
    assert E.TRACE_COUNT == builds + 1 and len(E.RUN_CACHE) == 1
    assert entry.dps is dps               # nothing sent to the device again
    # another cycle count is another entry of the same system: it shares
    # the DynParams and the kernel plans (a warm-up's plan serves the run)
    a.run(200, interval=4.0)
    assert E.RUN_CACHE.misses == 2 and E.TRACE_COUNT == builds + 2
    other = list(E.RUN_CACHE._runs.values())[1]
    assert other.dps is dps and other._uploads is entry._uploads
    assert sa.to_dict() == sb.to_dict()
    assert sa.to_dict() == JSim(*DDR4).run(300, interval=32.0).to_dict()
    assert E.RUN_CACHE.stats()["first_call_s"] > 0
    assert E.RUN_CACHE.stats()["shard_topologies"] == ("lanes",)
    with pytest.raises(NotImplementedError, match="item 12"):
        E.RUN_CACHE.get(a.cspec, a.controller, a.frontend, 10, shard=2,
                        device="cpu")


def test_edited_spec_gets_a_fresh_build():
    E.RUN_CACHE.clear()
    sim = Simulator(*DDR4, device="cpu")
    sim.run(300, interval=2.0)
    first = next(iter(E.RUN_CACHE._runs.values()))
    sim.cspec.rows = 2
    edited = sim.run(300, interval=2.0)
    assert E.RUN_CACHE.misses == 2 and len(E.RUN_CACHE) == 2
    # the first entry closed over a snapshot: the edit did not reach it
    assert first.msys.groups[0].cspec.rows != 2
    jsim = JSim(*DDR4)
    jsim.cspec.rows = 2
    assert edited.to_dict() == jsim.run(300, interval=2.0).to_dict()
    pristine = dataclasses.replace(sim.cspec, rows=first.msys.groups[0]
                                   .cspec.rows)
    assert E.spec_fingerprint(pristine) != E.spec_fingerprint(sim.cspec)


def test_profiler_spans_and_cache_delta():
    cache = E.RunCache()
    prof = T.Profiler(cache)
    assert set(cache.stats()) == {"entries", "hits", "misses",
                                  "first_call_s", "devices",
                                  "shard_topologies"}
    sim = Simulator(*DDR4, device="cpu")
    entry = lambda: cache.get(sim.msys, sim.controller, sim.frontend, 300,
                              device="cpu")
    from repro_torch.core import frontend as F
    fp = F.stack_params([(3.0, 1.0)], sim.frontend.probe_gap, "cpu")
    with prof.span("first"):
        entry()(fp, 1)
    for _ in range(2):
        with prof.span("warm"):
            entry()(fp, 1)
    prof.add("extra", 0.25)
    r = prof.report()
    assert r["spans"]["first"]["calls"] == 1
    assert r["spans"]["warm"]["calls"] == 2
    assert r["spans"]["extra"] == {"s": 0.25, "calls": 1}
    assert r["wall_s"] >= r["spans"]["first"]["s"]
    assert (r["cache"]["misses"], r["cache"]["hits"],
            r["cache"]["entries"]) == (1, 2, 1)
    assert r["cache"]["first_call_s"] > 0 and r["cache"]["devices"] == 1
    assert "programs" in prof.summary()


def test_profile_run_cold_warm():
    E.RUN_CACHE.clear()
    sim = Simulator("DDR5", "DDR5_16Gb_x8", "DDR5_4800B", device="cpu")
    p = T.profile_run(sim, 300, repeats=1, interval=2.0)
    assert set(p) == {"first_call_s", "warm_s", "compile_s",
                      "cycles_per_sec", "scan_steps", "skipped_cycles",
                      "idle_fraction", "cache"}
    assert p["first_call_s"] > 0 and p["warm_s"] > 0
    assert p["compile_s"] >= 0 and p["cycles_per_sec"] > 0
    assert (p["cache"]["misses"], p["cache"]["hits"]) == (1, 1)
    assert p["scan_steps"] + p["skipped_cycles"] == 300
    p_tel = T.profile_run(sim, 300, repeats=1, interval=2.0, telemetry=128)
    assert p_tel["cycles_per_sec"] > 0
