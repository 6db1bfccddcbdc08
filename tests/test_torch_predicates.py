"""PyTorch port, the modern-controller predicates and the link latency on
the CPU, against the JAX package (exact):

* ``step_and_horizon_plain`` against the reference's ``controller_step``
  and ``channel_horizon`` at ``clk + 1``, with BlockHammer (sketch counts
  around the threshold), PRAC (counters at and below it), a user
  predicate, and a link latency of 0 or 80 with arrivals on both sides of
  the boundary; stepped through 12 consecutive cycles and then around two
  ``nREFI`` multiples (the sketch decay); DDR4, LPDDR5 (split
  activation) and HBM3 (dual command bus: the sketch halves once per
  pass);
* short end-to-end runs of ``tests/core/test_controllers.py``'s
  configurations — BlockHammer at threshold 8 on 2 rows, PRAC at 16 on 4
  rows, the ``no_writes_ever`` user predicate — whose ``Stats`` equal the
  reference's, with predicate deferrals where the reference shows them;
* the predicates' order and the BlockHammer hashes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core import ControllerConfig as JCfg           # noqa: E402
from repro.core import FrontendConfig as JFcfg            # noqa: E402
from repro.core import Simulator as JSim                  # noqa: E402
from repro.core import controller as JC                   # noqa: E402

from repro_torch import convert                           # noqa: E402
from repro_torch.core import (ControllerConfig, FrontendConfig,  # noqa: E402
                              Simulator, compile_spec)
from repro_torch.core import controller as TC             # noqa: E402
from repro_torch.core.standards import DEFAULT_SYSTEMS    # noqa: E402
from repro_torch.testing import predicate_clocks          # noqa: E402

from torch_parity import (assert_tree_equal, predicate_ctrl,  # noqa: E402
                          tree_np)


def no_writes_ever(cspec, ctx):
    """The reference test's user predicate; the same expression runs on
    the reference's and the port's tensors."""
    return ctx.cand_cmd != cspec.id_WR


CASES = {
    "DDR4-bh": ("DDR4", dict(blockhammer_threshold=3), 0),
    "DDR4-prac": ("DDR4", dict(prac_threshold=4), 0),
    "DDR4-all-link80": ("DDR4", dict(blockhammer_threshold=3,
                                     prac_threshold=4,
                                     extra_predicates=(no_writes_ever,)),
                        80),
    "DDR4-link80": ("DDR4", dict(), 80),
    "LPDDR5-bh-prac": ("LPDDR5", dict(blockhammer_threshold=2,
                                      prac_threshold=3), 0),
    "HBM3-bh-prac-link80": ("HBM3", dict(blockhammer_threshold=3,
                                         prac_threshold=4), 80),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_matches_reference(case):
    std, opts, link = CASES[case]
    org, tim = DEFAULT_SYSTEMS[std]
    jc, jdp, cs, clk = predicate_ctrl(
        std, org, tim, seed=len(case), bh=opts.get("blockhammer_threshold",
                                                   0),
        prac=opts.get("prac_threshold", 0), link=link)
    jcfg, tcfg = JCfg(**opts), ControllerConfig(**opts)

    @jax.jit
    def ref(s, c):
        s, ev = JC.controller_step(jc, jdp, jcfg, s, c, link)
        return s, ev, JC.channel_horizon(jc, jdp, jcfg, s, c + 1, link)

    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    tcs = convert.ctrl_state(tree_np(cs), "cpu")
    issued = deferred = 0
    for t in predicate_clocks(clk, int(jc.timings["nREFI"])):
        cs, ev, h = ref(cs, jnp.int32(t))
        tcs, tev, th = TC.step_and_horizon_plain(cspec, dp, tcfg, tcs, t,
                                                 link)
        assert_tree_equal(tree_np(ev), tev, f"{case} events @ {t}")
        assert_tree_equal(tree_np(cs), tcs, f"{case} state @ {t}")
        assert int(th[0]) == int(h), (case, t)
        issued += int((np.asarray(ev.cmd) >= 0).sum())
        deferred += int(ev.deferred)
    assert issued > 0
    if opts:
        assert deferred > 0, case


def test_predicates_in_reference_order_and_hashes():
    cfg = ControllerConfig(blockhammer_threshold=8, prac_threshold=16,
                           extra_predicates=(no_writes_ever,))
    ddr4 = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    lp5 = compile_spec("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400")
    names = [p.__qualname__ for p in cfg.predicates()]
    assert names == ["pred_refresh_urgency", "pred_act2_follows_act1",
                     "pred_act2_exclusive",
                     "make_pred_blockhammer.<locals>.pred",
                     "make_pred_prac.<locals>.pred", "no_writes_ever"]
    assert len(cfg.predicates(ddr4)) == 4 and len(cfg.predicates(lp5)) == 6
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 128, 4096)
    row = rng.integers(-2**31, 2**31, 4096)
    want = JC._bh_hashes(jnp.asarray(bank, jnp.int32),
                         jnp.asarray(row, jnp.int32))
    got = TC._bh_hashes(torch.as_tensor(bank, dtype=torch.int32),
                        torch.as_tensor(row, dtype=torch.int32))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


#: tests/core/test_controllers.py's configurations, shortened
SESSIONS = {
    "blockhammer": (dict(blockhammer_threshold=8), dict(pattern="random",
                                                        probes=False),
                    2, 1200, 1.0),
    "prac": (dict(prac_threshold=16), dict(pattern="random", probes=False),
             4, 2000, 1.0),
    "no_writes_ever": (dict(extra_predicates=(no_writes_ever,)),
                       dict(probes=False), None, 400, 0.5),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_predicate_sessions_match_reference(name):
    ctrl, front, rows, n, ratio = SESSIONS[name]
    sys = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    jsim = JSim(*sys, controller=JCfg(**ctrl), frontend=JFcfg(**front))
    tsim = Simulator(*sys, controller=ControllerConfig(**ctrl),
                     frontend=FrontendConfig(**front), device="cpu")
    if rows:                    # hammer: a tiny row space, set after build
        jsim.cspec.rows = rows
        tsim.cspec.rows = rows
    want = jsim.run(n, interval=2.0, read_ratio=ratio).to_dict()
    plain = TC.plain_calls
    got = tsim.run(n, interval=2.0, read_ratio=ratio)
    assert got.to_dict() == want
    assert TC.plain_calls - plain == got.scan_steps     # one per CPU step
    counts = dict(zip(tsim.cspec.cmd_names, want["cmd_counts"]))
    if name == "no_writes_ever":
        assert counts["WR"] == 0 and counts["RD"] > 0
    else:
        assert want["deferred"] > 0
    if name == "prac":          # recoveries beyond the time-based REFabs
        assert counts["REFab"] > (n // tsim.cspec.timings["nREFI"]) \
            * tsim.cspec.n_refresh_units
