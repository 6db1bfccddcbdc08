"""PyTorch port, the fused controller step on the CPU.

* ``step_and_horizon_plain`` — the fused kernel's plain version — against
  the JAX package: ``controller_step`` and then ``channel_horizon`` at
  ``clk + 1``, 40 cycles in a row from random controller states (a legal
  device history, a queue with arrival ties, refresh units around their
  due time) of all 11 default systems, with both schedulers.  Exact.
* The kernel's plan, built on the CPU, field by field against the spec
  tables: bank and node of every address, banks per refresh unit, the
  command-kind masks of each pass, FX bits, scopes, ring ownership, the
  readiness keys; and the plan's and events' layouts against the enums of
  ``csrc/controller_step.cu``.
* The plain step over ``P x C`` lanes at per-point clocks with inactive
  points (``step_lanes_plain``, the batched kernel's yardstick) against
  per-point scalar ``step_and_horizon_plain``.
* The wrapper raises for what the kernel does not take, before any build
  or launch; the user predicates' device mask equals what the plain pass's
  predicates see, and on the card it rides the kernel (one launch per
  pass of a dual command bus); the library digest follows the headers a
  source includes.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
(``-m cuda``) and ``chip_smoke.py`` hold it against this plain version."""
import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core import controller as JC                   # noqa: E402

from repro_torch import convert                            # noqa: E402
from repro_torch import testing as T                       # noqa: E402
from repro_torch.core import compile_spec                  # noqa: E402
from repro_torch.core import controller as TC              # noqa: E402
from repro_torch.core import device as TD                  # noqa: E402
from repro_torch.core.standards import DEFAULT_SYSTEMS     # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels import controller_step as KS      # noqa: E402

from torch_parity import (assert_tree_equal, random_ctrl,  # noqa: E402
                          tree_np)

SYSTEMS = [(s, o, t) for s, (o, t) in sorted(DEFAULT_SYSTEMS.items())]
SOURCE = build.CSRC / "controller_step.cu"


@pytest.mark.parametrize("scheduler", ["FRFCFS", "FCFS"])
@pytest.mark.parametrize("std,org,tim", SYSTEMS)
def test_step_and_horizon_plain_matches_reference(std, org, tim, scheduler):
    jc, jdp, cs, clk = random_ctrl(std, org, tim, seed=3)
    jcfg = JC.ControllerConfig(scheduler=scheduler)
    tcfg = TC.ControllerConfig(scheduler=scheduler)

    @jax.jit
    def ref(s, c):
        s, ev = JC.controller_step(jc, jdp, jcfg, s, c)
        return s, ev, JC.channel_horizon(jc, jdp, jcfg, s, c + 1)

    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    tcs = convert.ctrl_state(tree_np(cs), "cpu")
    issued = 0
    for t in range(clk, clk + 40):
        cs, ev, h = ref(cs, jnp.int32(t))
        tcs, tev, th = TC.step_and_horizon_plain(cspec, dp, tcfg, tcs, t)
        assert_tree_equal(tree_np(ev), tev, f"{std} events @ {t}")
        assert_tree_equal(tree_np(cs), tcs, f"{std} state @ {t}")
        assert th.shape == (1,) and int(th[0]) == int(h), (std, t)
        issued += int((np.asarray(ev.cmd) >= 0).sum())
    assert issued > 0


LANE_SYSTEMS = [(s, *DEFAULT_SYSTEMS[s]) for s in ("DDR4", "LPDDR5", "HBM3")]


@pytest.mark.parametrize("std,org,tim", LANE_SYSTEMS)
@pytest.mark.parametrize("points,channels,reset", [
    (1, 2, True), (3, 2, False), (4, 1, False), (2, 4, True)])
def test_lane_step_equals_per_point_steps(std, org, tim, points, channels,
                                          reset):
    """Each active point's lanes take one scalar step at the point's own
    clock; an inactive point's lanes keep their state, give idle events
    and the horizon HORIZON_MAX."""
    cspec = compile_spec(std, org, tim, channels=channels)
    dp = TD.dyn_params(cspec, "cpu", channels)
    cfg = TC.ControllerConfig()
    cs, clk, active = T.lane_case(cspec, dp, "cpu", 5, points, channels,
                                  reset)
    for step in range(3):
        plain = TC.plain_calls
        got_cs, got_ev, got_h = TC.step_and_horizon(
            cspec, dp, cfg, T.clone_ctrl(cs), clk, active)
        assert TC.plain_calls == plain + int(active.sum())
        lanes = lambda t, p: t[p]
        for p in range(points):
            part = TC._tree(lambda t: lanes(t, p), cs)
            if bool(active[p]):
                want_cs, want_ev, want_h = TC.step_and_horizon_plain(
                    cspec, dp, cfg, part, int(clk[p]))
            else:
                want_cs, want_ev = part, TC.idle_events(channels, "cpu")
                want_h = torch.full((channels,), TC.HORIZON_MAX,
                                    dtype=torch.int32)
            assert not T.ctrl_diff(TC._tree(lambda t: lanes(t, p), got_cs),
                                   want_cs), (p, step)
            assert not T.events_diff(TC._tree(lambda t: lanes(t, p), got_ev),
                                     want_ev), (p, step)
            assert torch.equal(lanes(got_h, p), want_h), (p, step)
        cs, clk = got_cs, clk + 1


def test_dispatch_runs_the_plain_step_on_the_cpu():
    std, org, tim = SYSTEMS[0]
    jc, jdp, cs, clk = random_ctrl(std, org, tim, seed=2)
    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    cfg = TC.ControllerConfig()
    a = convert.ctrl_state(tree_np(cs), "cpu")
    b = convert.ctrl_state(tree_np(cs), "cpu")
    launches, plain = KS.launch_count, TC.plain_calls
    got = T.step_one_point(cspec, dp, cfg, a, clk)
    want = TC.step_and_horizon_plain(cspec, dp, cfg, b, clk)
    assert KS.launch_count == launches and TC.plain_calls == plain + 2
    for x, y in zip(got[:2], want[:2]):
        for u, v in zip(x, y):
            if isinstance(u, tuple):
                assert all(torch.equal(p, q) for p, q in zip(u, v))
            else:
                assert torch.equal(u, v)
    assert torch.equal(got[2], want[2])
    cs1, ev1, h1 = T.step_one_point(cspec, dp, cfg, b, clk + 1, False)
    assert ev1.cmd.shape == (1, 2) and h1 is None


def test_cycle_reads_back_only_its_one_sync():
    """A cycle's only device-to-host read is the engine's packed (busy,
    horizon) sync: no op reads a 0-d tensor back (``masked_fill`` with a
    tensor value does, once per field, on CUDA a sync each)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Simulator
    std, org, tim = SYSTEMS[2]
    sim = Simulator(std, org, tim, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = sim.run(60, interval=2.0, read_ratio=0.8)
    reads = [e.key for e in prof.events()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert reads == [] and sim.host_syncs == stats.scan_steps == 60


def _plan(std, org, tim, depth=32, channels=1, link=0, **cfg):
    cspec = compile_spec(std, org, tim)
    dp = TD.dyn_params(cspec, "cpu", channels)
    plan = KS.build_plan(cspec, dp, TC.ControllerConfig(**cfg), depth,
                         channels, "cpu", 1, link)
    return cspec, dp, plan


@pytest.mark.parametrize("std,org,tim", SYSTEMS)
def test_plan_fields_match_the_spec_tables(std, org, tim):
    cspec, dp, plan = _plan(std, org, tim, depth=8, channels=3,
                            scheduler="FCFS", refresh_enabled=False)
    tab = dp.tables
    d = plan.dim
    L1 = len(cspec.levels) - 1
    assert (d("Q"), d("L1"), d("F"), d("B"), d("U"), d("N")) == (
        8, L1, cspec.n_cmds, cspec.n_banks, cspec.n_refresh_units,
        cspec.num_nodes)
    assert (d("R"), d("W"), d("NRing")) == (
        max(cspec.n_ring, 1), cspec.ring_depth, cspec.n_ring)
    assert (d("Fcfs"), d("Refresh"), d("UrgentMargin")) == (1, 0, 4)
    assert (d("Split"), d("Dcs"), d("Dual")) == (
        cspec.split_activation, cspec.data_clock_sync,
        cspec.dual_command_bus)
    assert (d("NREFI"), d("NAAD"), d("ClockIdle"), d("ReadLatency")) == (
        dp.nREFI, dp.nAAD, dp.clock_idle, dp.read_latency)
    assert (d("LinkLatency"), d("BhThreshold"), d("PracThreshold")) == (
        0, 0, 0)
    # the modern-controller words: a group's link and the two thresholds
    _, _, other = _plan(std, org, tim, link=80, blockhammer_threshold=8,
                        prac_threshold=16)
    assert (other.dim("LinkLatency"), other.dim("BhThreshold"),
            other.dim("PracThreshold")) == (80, 8, 16)
    # each word picks its feature's kernel instance
    f = KS.FEATURE
    assert plan.features == 0
    assert other.features == f["FeatLink"] | f["FeatBh"] | f["FeatPrac"]
    # ... and nothing else: the tables after the header are the same
    np.testing.assert_array_equal(other.host[H_TABLES:],
                                  plan.host[H_TABLES:])

    # bank and node of every address; the refresh unit is sub[0] and owns
    # the banks [u * Bpr, (u + 1) * Bpr)
    counts = [int(c) for c in cspec.level_counts[1:]]
    sub = np.asarray(list(itertools.product(*map(range, counts))), np.int64)
    bank = sub @ plan.table("BankStride")
    want = TD.flat_bank(cspec, tab, torch.as_tensor(sub, dtype=torch.int32))
    np.testing.assert_array_equal(bank, want.numpy())
    assert sorted(bank.tolist()) == list(range(cspec.n_banks))
    assert d("Bpr") * d("U") == cspec.n_banks
    np.testing.assert_array_equal(bank // d("Bpr"), sub[:, 0])
    np.testing.assert_array_equal(bank // d("Bpr"), tab.bank_ru.numpy()[bank])
    nodes = sub @ plan.table("NodeMul") + plan.table("NodeOff")
    want = TD.node_per_level(cspec, tab,
                             torch.as_tensor(sub, dtype=torch.int32))
    np.testing.assert_array_equal(nodes, want.numpy())

    # command tables: kind masks of each pass, FX bits, scopes
    passes = plan.table("Pass")
    if cspec.dual_command_bus:
        np.testing.assert_array_equal(passes & 1, tab.col_cmds.numpy())
        np.testing.assert_array_equal(passes >> 1 & 1, tab.row_cmds.numpy())
        assert not (tab.col_cmds & tab.row_cmds).any()
    else:
        assert (passes == 1).all()
    np.testing.assert_array_equal(plan.table("Fx"), cspec.cmd_fx)
    np.testing.assert_array_equal(plan.table("Scope"), cspec.cmd_scope)

    # ring ownership: entry r belongs to (ring_cmd[r], the node ring_node[r]
    # at level ring_level[r]), a node of that level
    np.testing.assert_array_equal(plan.table("RingCmd"), cspec.ring_cmd)
    np.testing.assert_array_equal(plan.table("RingLevel"), cspec.ring_level)
    np.testing.assert_array_equal(plan.table("RingNode"), cspec.ring_node)
    offs = np.asarray(cspec.level_offsets)
    for r, (lvl, node) in enumerate(zip(plan.table("RingLevel"),
                                        plan.table("RingNode"))):
        assert node in nodes[:, lvl], (std, r)
        assert offs[lvl] <= node < offs[lvl] + np.prod(
            cspec.level_counts[:lvl + 1]), (std, r)

    # readiness keys and constraint matrix, command ids
    np.testing.assert_array_equal(plan.table("Keys"), tab.ready.keys.numpy())
    np.testing.assert_array_equal(plan.table("A"), tab.ready.A.numpy())
    opener = cspec.id_ACT1 if cspec.split_activation else cspec.id_ACT
    assert (d("IdOpener"), d("IdAct2"), d("IdPre"), d("IdRd"), d("IdWr"),
            d("IdRefab"), d("IdPreab")) == (
        opener, cspec.id_ACT2, cspec.id_PRE, cspec.id_RD, cspec.id_WR,
        cspec.id_REFab, cspec.id_PREab)
    if cspec.data_clock_sync:
        assert min(d("IdSyncRd"), d("IdSyncWr")) >= 0
    assert d("NConsts") == plan.host.size <= KS.LIMITS["MaxConsts"]
    assert plan.consts.dtype == torch.int32 and plan.out.shape == (3, 16)


#: the first table word of a plan: the header's length
H_TABLES = KS.H["HeaderWords"]


def _enum(name: str) -> list:
    body = re.search(r"enum %s : int \{(.*?)\};" % name,
                     SOURCE.read_text(), re.S).group(1)
    return [e.strip() for e in body.split(",") if e.strip()]


def test_plan_and_event_layout_match_the_source():
    assert [e[1:] for e in _enum("Header")] == list(KS.HEADER)
    events = dict(e[1:].replace(" ", "").split("=") for e in _enum("Event"))
    assert {k: int(v) for k, v in events.items()} == KS.EVENT
    consts = dict(re.findall(r"constexpr int k(\w+) = (\d+);",
                             SOURCE.read_text()))
    assert {k: int(consts[k]) for k in KS.LIMITS} == KS.LIMITS
    ptrs = re.search(r"struct StepPtrs \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    names = re.findall(r"\*\s*(\w+);", ptrs)
    assert tuple(names) == KS.PTRS and KS.NUM_PTRS == 21
    feats = dict(e[1:].replace(" ", "").split("=") for e in _enum("Feature"))
    assert {k: int(v) for k, v in feats.items()} == KS.FEATURE


def test_events_view_reads_the_packed_row():
    out = torch.zeros((2, 16), dtype=torch.int32)
    out[:, :11] = torch.arange(22, dtype=torch.int32).reshape(2, 11) + 100
    by = out.view(torch.uint8)
    by[1, [48, 50, 52]] = 1
    ev, h = TC._events_view(out)
    out[:, 11] = torch.tensor([7, 9], dtype=torch.int32)
    assert ev.cmd.tolist() == [[100, 101], [111, 112]]
    assert ev.arrive[1].tolist() == [117, 118]
    assert ev.probe_latency.tolist() == [108, 119]
    assert ev.deferred.tolist() == [110, 121] and h.tolist() == [7, 9]
    assert ev.hit_ready.dtype == torch.bool
    assert ev.hit_ready.tolist() == [[False, False], [True, False]]
    assert ev.served_read.tolist() == [False, True]
    assert ev.served_write.tolist() == [False, False]
    assert ev.served_probe.tolist() == [False, True]


def test_wrapper_raises_for_what_the_kernel_does_not_take():
    std, org, tim = SYSTEMS[1]
    with pytest.raises(ValueError, match="queue depth 300"):
        _plan(std, org, tim, depth=300)
    with pytest.raises(ValueError, match="needs a queue"):
        _plan(std, org, tim, depth=0)
    with pytest.raises(ValueError, match="link latency -1"):
        _plan(std, org, tim, link=-1)
    cspec, dp, plan = _plan(std, org, tim, depth=16, channels=2)
    cs = TC.init_ctrl_state(cspec, 16, 2, "cpu", points=1)
    clk = torch.tensor([5], dtype=torch.int32)
    on = torch.tensor([True])
    bad_dtype = cs._replace(dev=cs.dev._replace(
        last_issue=cs.dev.last_issue.long()))
    bad_shape = cs._replace(queue=cs.queue._replace(
        row=torch.zeros((1, 2, 8), dtype=torch.int32)))
    strided = cs._replace(queue=cs.queue._replace(
        arrive=torch.zeros((16, 2), dtype=torch.int32).t()[None]))
    bad_sketch = cs._replace(bh_sketch=torch.zeros((1, 2, 2, 512),
                                                   dtype=torch.int32))
    for state, match in ((bad_dtype, "last_issue"), (bad_shape, "queue.row"),
                         (strided, "queue.arrive"),
                         (bad_sketch, "bh_sketch"), (cs, "CUDA tensors")):
        with pytest.raises(ValueError, match=match):
            KS.controller_step_cuda(plan, state, clk, on, True)
    # the clocks are per-point int32 tensors, one per point of the plan
    for bad_clk, bad_on, match in ((5, on, "clk"), (clk.long(), on, "clk"),
                                   (torch.tensor([5, 6], dtype=torch.int32),
                                    on, "clk"), (clk, True, "active")):
        with pytest.raises(ValueError, match=match):
            KS.controller_step_cuda(plan, cs, bad_clk, bad_on, True)
    # the user mask is (P, C, Q) bool; a single bus has no row pass
    for mask in (torch.ones((1, 2, 15), dtype=torch.bool),
                 torch.ones((1, 2, 16), dtype=torch.int32)):
        with pytest.raises(ValueError, match="user_mask"):
            KS.controller_step_cuda(plan, cs, clk, on, True, mask)
    with pytest.raises(ValueError, match="only_pass 1"):
        KS.controller_step_cuda(plan, cs, clk, on, True, None, 1)
    # the clocks stay in [0, 2**30): a run checks its length before a launch
    from repro_torch.core import Simulator
    with pytest.raises(ValueError, match="clocks below 2"):
        Simulator(std, org, tim, device="cpu").run(2**30 + 1)
    assert KS._LIB is None              # nothing was built or launched
    meta = TC.init_ctrl_state(cspec, 16, 2, "meta", points=1)
    with pytest.raises(NotImplementedError):
        TC.controller_step(cspec, dp, TC.ControllerConfig(), meta, clk, on)


@pytest.mark.parametrize("std", ["DDR4", "HBM3", "LPDDR5"])
def test_user_mask_is_the_plain_pass_verdict(std):
    """``user_mask`` over all lanes at per-point clocks equals, point by
    point, what the user predicates return inside the plain pass — on a
    dual command bus for the column pass and, on the state it leaves, the
    row pass."""
    org, tim = DEFAULT_SYSTEMS[std]
    cspec = compile_spec(std, org, tim, channels=2)
    dp = TD.dyn_params(cspec, "cpu", 2)
    seen = []

    def pred(cspec, ctx):
        v = T.reads_every_field(cspec, ctx)
        seen.append(v.expand_as(ctx.cand_cmd).clone())
        return v
    cfg = TC.ControllerConfig(extra_predicates=(pred,))
    cs, clk, _ = T.lane_case(cspec, dp, "cpu", 5, 3, 2, False)
    tab = dp.tables
    kinds = [tab.col_cmds, tab.row_cmds] if cspec.dual_command_bus \
        else [None]
    for cmd_ok in kinds:
        seen.clear()
        got = TC.user_mask(cspec, dp, cfg, cs, clk)
        seen.clear()
        parts = []
        for p, t in enumerate(clk.tolist()):
            cs_p, _ = TC._select_and_issue(
                cspec, dp, TC._tree(lambda a: a[p].clone(), cs), t, cfg,
                cfg.predicates(cspec), cmd_ok, TC.frfcfs)
            parts.append(cs_p)
        assert got.shape == cs.queue.valid.shape and got.dtype == torch.bool
        assert torch.equal(got, torch.stack(seen))
        assert 0 < int(got.sum()) < got.numel()
        cs = TC._tree(lambda *xs: torch.stack(xs), *parts)


@pytest.mark.parametrize("std", ["DDR4", "HBM3"])
def test_user_predicates_ride_the_kernel_on_the_card(std, monkeypatch):
    """Where the state would take the kernel (the device kind made "cuda"
    here, the launch recorded), a configuration with user predicates
    launches the kernel with their mask — once, or once per pass of a dual
    command bus, each mask on the state its pass starts from — and never
    the plain step."""
    org, tim = DEFAULT_SYSTEMS[std]
    cspec = compile_spec(std, org, tim, channels=2)
    dp = TD.dyn_params(cspec, "cpu", 2)
    cfg = TC.ControllerConfig(extra_predicates=(T.reads_every_field,))
    cs, clk, active = T.lane_case(cspec, dp, "cpu", 7, 3, 2, False)
    calls = []

    def launch(plan, cs, clk, active, horizon, user_mask=None,
               only_pass=-1):
        calls.append((only_pass, horizon, user_mask.clone()))
        cs.dev.row_state.fill_(TD.ROW_CLOSED)   # an in-place update
    monkeypatch.setattr(TC, "_device_kind", lambda cs: "cuda")
    monkeypatch.setattr(KS, "controller_step_cuda", launch)
    plain = TC.plain_calls
    for horizon in (True, False):
        calls.clear()
        start = T.clone_ctrl(cs)
        fn = TC.step_and_horizon if horizon else TC.controller_step
        fn(cspec, dp, cfg, cs, clk, active)
        if cspec.dual_command_bus:
            assert [c[:2] for c in calls] == [(0, False), (1, horizon)]
            moved = start._replace(dev=start.dev._replace(
                row_state=torch.full_like(start.dev.row_state,
                                          TD.ROW_CLOSED)))
            assert torch.equal(calls[1][2], TC.user_mask(
                cspec, dp, cfg, moved, clk))
        else:
            assert [c[:2] for c in calls] == [(-1, horizon)]
        assert torch.equal(calls[0][2], TC.user_mask(cspec, dp, cfg, start,
                                                     clk))
    assert TC.plain_calls == plain and KS._LIB is None


def test_library_digest_follows_included_headers(tmp_path, monkeypatch):
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("controller_step")] == [
        "controller_step.cu", "readiness_keys.cuh"]
    before = {n: build.library_path(n)
              for n in ("controller_step", "readiness", "flash_attention")}
    hdr = tmp_path / "readiness_keys.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert after["controller_step"] != before["controller_step"]
    assert after["readiness"] != before["readiness"]
    assert after["flash_attention"] == before["flash_attention"]
