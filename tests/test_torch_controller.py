"""PyTorch port, device and controller.

The same random controller state (a legal device history from the
reference's oracle, a random queue with arrival ties, refresh units near
and past due) goes through both packages: ``prereq``, ``issue``,
``controller_step`` (events and next state, several cycles in a row) and
``channel_horizon_plain`` must agree exactly.  DDR4 (one bus), LPDDR5 (split
activation, data-clock sync) and HBM3 (dual command bus) are covered."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core import controller as JC                   # noqa: E402
from repro.core import device as JD                       # noqa: E402

from repro_torch import convert                            # noqa: E402
from repro_torch.core import compile_spec                  # noqa: E402
from repro_torch.core import controller as TC              # noqa: E402
from repro_torch.core import device as TD                  # noqa: E402

from torch_parity import (TRIO, assert_tree_equal,         # noqa: E402
                          random_ctrl, tree_np)


def _port_of(std, org, tim, jdp, cs):
    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    return cspec, dp, convert.ctrl_state(tree_np(cs), "cpu")


@pytest.mark.parametrize("std,org,tim", TRIO)
@pytest.mark.parametrize("seed", [1, 2])
def test_prereq_and_issue_match_reference(std, org, tim, seed):
    jc, jdp, cs, clk = random_ctrl(std, org, tim, seed)
    cspec, dp, tcs = _port_of(std, org, tim, jdp, cs)
    q = cs.queue
    for t in (clk, clk + 7, clk + 400):
        want = jax.vmap(lambda w, s, r: JD.prereq(jc, jdp, cs.dev, w, s, r,
                                                  jnp.int32(t)))(
            q.is_write, q.sub, q.row)
        got = TD.prereq(cspec, dp, tcs.dev, tcs.queue.is_write,
                        tcs.queue.sub, tcs.queue.row, t)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    # issue every slot's prerequisite command, enabled and disabled
    cmd, row, _ = [np.asarray(a) for a in want]
    for slot in range(6):
        for en in (True, False):
            jst = JD.issue(jc, jdp, cs.dev, jnp.int32(cmd[slot]),
                           q.sub[slot], jnp.int32(row[slot]),
                           jnp.int32(clk), jnp.asarray(en))
            tst = TD.issue(cspec, dp, tcs.dev,
                           torch.tensor([int(cmd[slot])], dtype=torch.int32),
                           tcs.queue.sub[:, slot],
                           torch.tensor([int(row[slot])], dtype=torch.int32),
                           clk, torch.tensor([en]))
            assert_tree_equal(tree_np(jst), tst, f"{std} slot {slot}")


@pytest.mark.parametrize("std,org,tim", TRIO)
@pytest.mark.parametrize("scheduler", ["FRFCFS", "FCFS"])
def test_controller_step_and_horizon_match_reference(std, org, tim,
                                                     scheduler):
    jc, jdp, cs, clk = random_ctrl(std, org, tim, seed=4)
    jcfg = JC.ControllerConfig(scheduler=scheduler)
    tcfg = TC.ControllerConfig(scheduler=scheduler)
    step = jax.jit(lambda s, c: JC.controller_step(jc, jdp, jcfg, s, c))
    hor = jax.jit(lambda s, c: JC.channel_horizon(jc, jdp, jcfg, s, c))
    cspec, dp, tcs = _port_of(std, org, tim, jdp, cs)
    issued = 0
    for t in range(clk, clk + 40):
        h_want = int(hor(cs, jnp.int32(t)))
        h_got = TC.channel_horizon_plain(cspec, dp, tcfg, tcs, t)
        assert int(h_got[0]) == h_want, (std, t)
        cs, ev = step(cs, jnp.int32(t))
        tcs, tev = TC.controller_step_plain(cspec, dp, tcfg, tcs, t)
        assert_tree_equal(tree_np(ev), tev, f"{std} events @ {t}")
        assert_tree_equal(tree_np(cs), tcs, f"{std} state @ {t}")
        issued += int((np.asarray(ev.cmd) >= 0).sum())
    assert issued > 0


def test_oldest_breaks_arrival_ties_to_the_first_slot():
    mask = torch.tensor([[False, True, True, True]])
    arrive = torch.tensor([[0, 5, 5, 9]], dtype=torch.int32)
    slot, ok = TC.fcfs(mask, torch.zeros_like(mask), arrive)
    want = JC.fcfs(jnp.asarray(mask[0].numpy()), jnp.zeros(4, bool),
                   jnp.asarray(arrive[0].numpy()))
    assert int(slot[0]) == int(want[0]) == 1 and bool(ok[0])


def test_queue_insert_takes_first_free_slot():
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    q = TC.empty_queue(cspec, 4, 2, "cpu")
    q = q._replace(valid=torch.tensor([[True, False, True, False],
                                       [True, True, True, True]]))
    sub = torch.tensor([0, 1, 2], dtype=torch.int32)
    one = torch.tensor(7, dtype=torch.int32)
    q2, ok = TC.queue_insert(q, True, False, sub, one, one, 3,
                             torch.tensor([True, True]))
    assert ok.tolist() == [True, False]
    assert q2.valid.tolist() == [[True, True, True, False], [True] * 4]
    assert q2.row[0].tolist() == [0, 7, 0, 0] and q2.arrive[0, 1] == 3
    assert q2.sub[0, 1].tolist() == [0, 1, 2] and bool(q2.is_write[0, 1])
    jq = JC.empty_queue(cspec, 4)._replace(
        valid=jnp.asarray([True, False, True, False]))
    jq2, jok = JC.queue_insert(jq, True, False, jnp.asarray(sub.numpy()),
                               7, 7, 3, True)
    assert bool(jok)
    np.testing.assert_array_equal(np.asarray(jq2.valid),
                                  q2.valid[0].numpy())
