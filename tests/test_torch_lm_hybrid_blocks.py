"""The hybrid recurrentgemma-2b's blocks in the port
(``repro_torch.models.blocks``): RG-LRU and local attention with its ring
KV cache, against the JAX package's on the CPU (op by op: the
reference's eager mode), with the config, the full-width parameter
shapes and count, and a model whose remainder layers the reference runs
op by op (logits at ``LOGITS_TOL``, atol 0.2 / rtol 0.05, its
decode-parity tolerance).  ``test_torch_lm_hybrid.py`` holds the rest of
the model.

Tolerances: the conv and GELU are bf16 ops the two packages round alike:
exact.  The fp32 gates and the recurrent state at the bf16 tolerance 2e-2
(they are fp32 functions of bf16 matrix products, and a product's bf16
result lands one ulp apart now and then: its sum runs in another order);
the scan alone at 1e-5 (another association order of the same fp32
products); one block's bf16 output and the ring's contents at 2e-2 of
the largest magnitude."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Batch as JBatch
from repro.models import blocks as JB
from repro.models import forward as jax_forward
from repro.models import param_defs as jax_param_defs
from repro.models.model import _prefill_attn_state as jax_prefill_state
from repro.models.model import count_params as jax_count_params
from repro.models.model import last_logits as jax_last_logits
from repro_torch.models import blocks as PB
from repro_torch.models import model as M
from repro_torch.models.layers import ParamTree
from torch_parity import (FAMILY_PARAMS, LOGITS_TOL, family_configs,
                          family_pair, prompts, rand, unstacked_shapes)

NAME = "recurrentgemma-2b"
BF16 = dict(atol=2e-2, rtol=2e-2)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def _close_scaled(got, want):
    scale = float(np.abs(_f32(want)).max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.fixture(scope="module")
def pair():
    return family_pair(NAME, seed=2)


def _layer(jp, pp, cfg, i):
    """Layer ``i``'s tree in both packages."""
    P = len(cfg.block_pattern)
    g, j = divmod(i, P)
    if g < cfg.n_groups():
        return jax.tree.map(lambda a: a[g], jp["groups"][f"b{j}"]), \
            pp["layers"][i]
    return jp["rem"][f"r{j}"], pp["layers"][i]


def _ctx(T, B=2, start=0, cache_index=0, cache_len=0):
    pos = np.arange(start, start + T, dtype=np.int32)[None].repeat(B, 0)
    return (JB.Ctx(positions=jnp.asarray(pos),
                   cache_index=jnp.int32(cache_index),
                   cache_len=jnp.int32(cache_len)),
            PB.Ctx(positions=torch.tensor(pos), cache_index=cache_index,
                   cache_len=cache_len))


def test_config_fields_equal():
    for full in (True, False):
        jc, pc = family_configs(NAME, full=full)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    _, pc = family_configs(NAME, full=True)
    assert (pc.n_layers, pc.head_dim, pc.n_heads, pc.n_kv_heads,
            pc.attn_window, pc.n_groups(), pc.n_remainder()) == \
        (26, 256, 10, 1, 2048, 8, 2)
    _, pr = family_configs(NAME)
    assert (pr.head_dim, pr.attn_window, pr.n_layers) == (32, 64, 6)


def test_full_width_param_shapes_and_count():
    jc, pc = family_configs(NAME, full=True)
    module = ParamTree(M.param_defs(pc), device="meta")   # no storage
    got = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert got == unstacked_shapes(jax_param_defs(jc), jc)
    assert got["layers.25.conv_w"] == (4, 2560)
    assert got["layers.2.wk"] == (2560, 256)
    n = FAMILY_PARAMS[NAME]
    assert sum(p.numel() for p in module.parameters()) == n
    assert M.count_params(pc) == pc.param_count() == jax_count_params(jc) == n


@pytest.mark.parametrize("T,carry", [(9, False), (2, False), (1, True),
                                     (5, True)])
def test_causal_conv4(T, carry):
    xj, xt = _bf16(rand((2, T, 64), 1, 2.0))
    wj, wt = _bf16(rand((4, 64), 2, 0.5))
    cj = ct = None
    if carry:
        cj, ct = _bf16(rand((2, 3, 64), 3, 2.0))
    oj, nj = JB._causal_conv4(xj, wj, carry=cj)
    ot, nt = PB._causal_conv4(xt, wt, carry=ct)
    np.testing.assert_array_equal(_f32(ot), _f32(oj))
    np.testing.assert_array_equal(_f32(nt), _f32(nj))
    assert ot.dtype == nt.dtype == torch.bfloat16
    # fp32_last: the same taps, the last sum left in fp32
    o32, _ = PB._causal_conv4(xt, wt, carry=ct, fp32_last=True)
    assert o32.dtype == torch.float32
    np.testing.assert_array_equal(_f32(o32.bfloat16()), _f32(oj))


def test_rglru_coeffs(pair):
    jc, jp, pc, pp = pair
    pj, pt = _layer(jp, pp, jc, 0)
    uj, ut = _bf16(rand((2, 11, 64), 4, 2.0))
    aj, gj = JB._rglru_coeffs(jc, pj, uj)
    at, gt = PB._rglru_coeffs(pc, pt, ut)
    assert at.dtype == gt.dtype == torch.float32
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **BF16)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **BF16)


def test_softplus_and_gelu_follow_jax():
    """``F.softplus`` turns linear above its threshold; ``jax.nn.softplus``
    is ``logaddexp(x, 0)`` everywhere; GELU is the tanh form, op by op."""
    x = np.float32([-30.0, -2.0, 0.0, 0.5, 19.0, 20.5, 40.0])
    np.testing.assert_allclose(PB._softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6)
    bj, bt = _bf16(rand((3, 50, 64), 5, 3.0))
    np.testing.assert_array_equal(_f32(PB._gelu(bt)), _f32(jax.nn.gelu(bj)))


@pytest.mark.parametrize("T", [1, 7, 100])
def test_linear_scan_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.0, 1.0, (2, T, 16)).astype(np.float32)
    u = rng.standard_normal((2, T, 16)).astype(np.float32)
    _, want = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jnp.asarray(a), jnp.asarray(u)), axis=1)
    got = PB.linear_scan(torch.tensor(a), torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rglru_apply_and_decode(pair):
    """Prefill of 20 tokens with its state, then 2 decode steps carrying
    it, in both packages (op by op: the reference's eager mode)."""
    jc, jp, pc, pp = pair
    pj, pt = _layer(jp, pp, jc, 1)
    xj, xt = _bf16(rand((2, 20, 64), 6, 1.0))
    cj, ct = _ctx(20)
    oj, sj = JB.rglru_apply(jc, pj, xj, cj, with_state=True)
    ot, st = PB.rglru_apply(pc, pt, xt, ct, with_state=True)
    _close_scaled(ot, oj)
    _close_scaled(st.h, sj.h)
    np.testing.assert_array_equal(_f32(st.conv), _f32(sj.conv))
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
    for i in range(2):
        xj, xt = _bf16(rand((2, 1, 64), 40 + i, 1.0))
        cj, ct = _ctx(1, start=20 + i, cache_index=20 + i,
                      cache_len=21 + i)
        oj, sj = JB.rglru_decode(jc, pj, xj, sj, cj)
        ot, st = PB.rglru_decode(pc, pt, xt, st, ct)
        _close_scaled(ot, oj)
        _close_scaled(st.h, sj.h)
    # a prompt shorter than the conv's 3 rows pads its carry on the left
    _, s2 = JB.rglru_apply(jc, pj, xj, cj, with_state=True)
    _, t2 = PB.rglru_apply(pc, pt, xt, ct, with_state=True)
    np.testing.assert_array_equal(_f32(t2.conv), _f32(s2.conv))


def test_local_attention_prefill_and_ring_decode(pair):
    """The local layer at T 70 > window 64, then decode steps past the
    window into a ring of 64 slots (slot ``index % 64``)."""
    jc, jp, pc, pp = pair
    pj, pt = _layer(jp, pp, jc, 2)
    T = jc.attn_window + 6
    xj, xt = _bf16(rand((2, T, 64), 7, 1.0))
    cj, ct = _ctx(T)
    _close_scaled(PB.attn_apply(pc, pt, xt, ct, local=True),
                  JB.attn_apply(jc, pj, xj, cj, local=True))
    sj = jax_prefill_state(jc, pj, cj, xj, T + 4, local=True)
    st = M._prefill_attn_state(pc, pt, ct, xt, T + 4, local=True)
    assert st.k.shape == (2, 64, 1, 32)
    _close_scaled(st.k, sj.k)
    _close_scaled(st.v, sj.v)
    for i in range(2):
        xj, xt = _bf16(rand((2, 1, 64), 50 + i, 1.0))
        cj, ct = _ctx(1, start=T + i, cache_index=T + i, cache_len=T + i + 1)
        oj, sj = JB.attn_decode(jc, pj, xj, sj, cj, local=True)
        ot, st2 = PB.attn_decode(pc, pt, xt, st, ct, local=True)
        assert st2 is st                      # the ring is written in place
        _close_scaled(ot, oj)
        _close_scaled(st.k, sj.k)
    # the global cache keeps its cache_len slots
    assert PB.attn_init_state(pc, 1, 100).k.shape[1] == 100
    assert PB.attn_init_state(pc, 1, 100, local=True).k.shape[1] == 64
    assert PB.attn_init_state(pc, 1, 10, local=True).k.shape[1] == 10


def test_remainder_layers_match_jax():
    """Five layers: one scanned group and an (R, R) remainder, which the
    reference runs op by op (the port unfused there)."""
    jc, jp, pc, pp = family_pair(NAME, seed=9, n_layers=5)
    assert (jc.n_groups(), jc.n_remainder()) == (1, 2)
    pr = prompts(jc, 2, 20, seed=10)          # test_rglru_apply's shapes
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    x, _ = jax_forward(jc, jp, JBatch(tokens=jnp.asarray(pr),
                                      positions=jnp.asarray(pos)))
    want = np.asarray(jax_last_logits(jc, jp, x))
    xt, _ = M.forward(pc, pp, M.Batch(tokens=torch.tensor(pr),
                                      positions=torch.tensor(pos)))
    np.testing.assert_allclose(M.last_logits(pc, pp, xt).numpy(), want,
                               **LOGITS_TOL)
