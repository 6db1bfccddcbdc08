"""PyTorch port, frontend.

The port carries the reference's uint32 LCG in int64 masked to 32 bits
and draws a cycle's values together as affine images of the cycle's
starting state; ``lcg_jump`` folds the bits of a host-side ``d`` in exact
Python integers.  Here: ``lcg_jump(d)`` equals ``d`` single ``_lcg``
steps for small ``d``, Python modular arithmetic for ``d`` up to 2**31,
and the reference's ``lcg_jump``; ``frontend_step``, ``arrival_horizon``
and ``idle_advance`` agree with the reference on the same random
states."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core import compile as JCmp                    # noqa: E402
from repro.core import controller as JC                   # noqa: E402
from repro.core import frontend as JF                     # noqa: E402
from repro.core.addrmap import make_layout as j_layout    # noqa: E402

from repro_torch import convert                            # noqa: E402
from repro_torch.core import compile_spec                  # noqa: E402
from repro_torch.core import frontend as TF                # noqa: E402

from torch_parity import TRIO, assert_tree_equal, tree_np  # noqa: E402

M32 = 1 << 32


def _py_jump(x, d, a, c):
    ra, rc = 1, 0
    for _ in range(d):
        ra, rc = (a * ra) % M32, (a * rc + c) % M32
    return (ra * x + rc) % M32


@pytest.mark.parametrize("k", [1, 5, 7, 13])
def test_lcg_jump_equals_single_steps_for_small_d(k):
    rng = np.random.default_rng(k)
    a, c = TF.lcg_affine(k)
    assert (a, c) == JF.lcg_affine(k)
    for x in rng.integers(0, M32, 8, dtype=np.uint64):
        t = torch.tensor(int(x), dtype=torch.int64)
        step = t
        for d in range(0, 40):
            got = TF.lcg_jump(t, d, a, c)
            assert int(got) == int(step), (k, int(x), d)
            for _ in range(k):
                step = TF._lcg(step)


@pytest.mark.parametrize("k", [6, 7, 13])
def test_lcg_jump_large_d_matches_modular_and_reference(k):
    rng = np.random.default_rng(100 + k)
    a, c = TF.lcg_affine(k)
    ds = [1 << 31, (1 << 31) - 1, 123_456_789] + [
        int(v) for v in rng.integers(0, 1 << 31, 5)]
    for d in ds:
        x = int(rng.integers(0, M32, dtype=np.uint64))
        got = int(TF.lcg_jump(torch.tensor(x, dtype=torch.int64), d, a, c))
        # closed form by Python modular arithmetic: d applications of
        # x -> a x + c are x -> a^d x + c (a^d - 1)/(a - 1), folded as a
        # geometric series mod 2**32 by repeated squaring
        ad, s, base, acc_c = 1, 0, a, c
        e = d
        while e:
            if e & 1:
                ad, s = (ad * base) % M32, (s * base + acc_c) % M32
            acc_c = (acc_c * base + acc_c) % M32
            base = (base * base) % M32
            e >>= 1
        assert got == (ad * x + s) % M32, d
        if d < (1 << 31):
            ref = int(JF.lcg_jump(jnp.uint32(x), jnp.int32(d), a, c))
            assert got == ref, d
    assert int(TF.lcg_jump(torch.tensor(5, dtype=torch.int64), 3, a, c)) \
        == _py_jump(5, 3, a, c)


def _random_front(rng, cap, busy=None):
    return JF.FrontState(
        accum_fp=jnp.int32(int(rng.integers(0, cap + 1))),
        rng=jnp.uint32(int(rng.integers(0, M32, dtype=np.uint64))),
        seq=jnp.int32(int(rng.integers(0, 5000))),
        probe_busy=jnp.asarray(bool(rng.random() < 0.5) if busy is None
                               else busy),
        probe_next=jnp.int32(int(rng.integers(0, 3000))),
        sent=jnp.int32(int(rng.integers(0, 100))),
        dropped_backpressure=jnp.int32(int(rng.integers(0, 100))),
        served=jnp.int32(int(rng.integers(0, 100))))


CFGS = [dict(), dict(interval=2.0, read_ratio=0.7),
        dict(interval=300.0, probes=False), dict(stream=False),
        dict(interval=0.5, pattern="random", read_ratio=0.3),
        dict(interval=7.25, probe_gap=3, mapper="RoBaRaCoCh")]


@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_arrival_horizon_and_idle_advance_match_reference(ci):
    rng = np.random.default_rng(ci)
    jcfg = JF.FrontendConfig(**CFGS[ci])
    tcfg = TF.FrontendConfig(**CFGS[ci])
    jfp, tfp = jcfg.params(), tcfg.params()
    assert tuple(int(v) for v in jfp) == tuple(tfp)
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    jcspec = JCmp.compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    k = JF.rng_draws_per_cycle(jcfg, ("single", j_layout(jcspec,
                                                         jcfg.mapper)))
    assert k == TF.rng_draws_per_cycle(
        tcfg, ("single", TF.front_tables(cspec, tcfg, 1, "cpu").layout))
    a, c = JF.lcg_affine(k)
    for _ in range(12):
        fs = _random_front(rng, jcfg.max_backlog_fp)
        tfs = convert.front_state(tree_np(fs), "cpu")
        cur = int(rng.integers(0, 4000))
        want = int(JF.arrival_horizon(jcfg, jfp, fs, jnp.int32(cur)))
        assert int(TF.arrival_horizon(tcfg, tfp, tfs, cur)) == want
        d = int(rng.integers(0, 5000))
        jadv = JF.idle_advance(jcfg, fs, jnp.int32(d), a, c, k)
        tadv = TF.idle_advance(tcfg, tfs, d, a, c, k)
        assert_tree_equal(tree_np(jadv), tadv, f"idle_advance d={d}")


@pytest.mark.parametrize("std,org,tim", TRIO)
@pytest.mark.parametrize("pattern", ["sequential", "random"])
def test_frontend_step_matches_reference(std, org, tim, pattern):
    """Inserts into a nearly full queue, so accepts and backpressure
    both occur, with the probe both idle and in flight."""
    rng = np.random.default_rng(len(std) + len(pattern))
    jcfg = JF.FrontendConfig(interval=1.5, read_ratio=0.6, pattern=pattern)
    tcfg = TF.FrontendConfig(interval=1.5, read_ratio=0.6, pattern=pattern)
    jc = JCmp.compile_spec(std, org, tim)
    cspec = compile_spec(std, org, tim)
    depth = 8
    q = JC.empty_queue(jc, depth)
    q = q._replace(valid=jnp.asarray(rng.random(depth) < 0.6))
    jq = jax.tree.map(lambda a: a[None], q)
    tq = convert.queue(tree_np(q), "cpu")
    fs = _random_front(rng, jcfg.max_backlog_fp, busy=False)
    tfs = convert.front_state(tree_np(fs), "cpu")
    jfp, tfp = jcfg.params(), tcfg.params()
    ft = TF.front_tables(cspec, tcfg, 1, "cpu")
    step = jax.jit(lambda fs, q, clk: JF.frontend_step(jc, jcfg, jfp, fs, q,
                                                       clk))
    for t in range(20):
        clk = 100 + t
        jq, fs = step(fs, jq, jnp.int32(clk))
        tq, tfs = TF.frontend_step(cspec, tcfg, tfp, tfs, tq, clk, ft)
        assert_tree_equal(tree_np(fs), tfs, f"front @ {clk}")
        assert_tree_equal(tree_np(jax.tree.map(lambda a: a[0], jq)), tq,
                          f"queue @ {clk}")
        if t == 10:        # free a few slots mid-way
            free = jnp.asarray(rng.random(depth) < 0.5)
            jq = jq._replace(valid=jq.valid & ~free[None])
            tq = tq._replace(valid=tq.valid & ~torch.tensor(
                np.array(free))[None])
    assert int(tfs.dropped_backpressure) > 0 and int(tfs.sent) > 0


def test_frontend_config_params_match_reference():
    for kw in CFGS:
        j = JF.FrontendConfig(**kw).params()
        t = TF.FrontendConfig(**kw).params()
        assert tuple(int(v) for v in j) == tuple(t)
        assert dataclasses.asdict(JF.FrontendConfig(**kw)) \
            == dataclasses.asdict(TF.FrontendConfig(**kw))
