"""The port's LM layers and attention block (``repro_torch.models``)
against the JAX package's, on the CPU, with the same numpy-made inputs.

bf16 results are compared at atol/rtol 2e-2, the reference's own bf16
tolerance (tests/kernels/test_flash_attention.py); for a block's output
the atol is 2e-2 of its largest magnitude.  The two packages round bf16
at other places (XLA evaluates elementwise chains its own way), which
moves a value by one or two bf16 ulps (2^-8 relative each) after a
product.  fp32 results at 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as JB
from repro.models import layers as JL
from repro_torch.models import blocks as PB
from repro_torch.models import layers as PL
from torch_parity import lm_configs, lm_pair, rand

BF16 = dict(atol=2e-2, rtol=2e-2)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def test_rmsnorm():
    xj, xt = _bf16(rand((2, 5, 64), 1, 2.0))
    sj, st = _bf16(rand((64,), 2))
    np.testing.assert_allclose(_f32(PL.rmsnorm(xt, st, 1e-6)),
                               _f32(JL.rmsnorm(xj, sj, 1e-6)), **BF16)
    xf = rand((3, 64), 3)
    np.testing.assert_allclose(
        _f32(PL.rmsnorm(torch.tensor(xf), st)),
        _f32(JL.rmsnorm(jnp.asarray(xf), sj)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    x = rand((2, 7, 4, 32), 4, 1.0)
    pos = np.random.default_rng(5).integers(0, 1000, (2, 7)).astype(np.int32)
    if dtype == "bfloat16":
        xj, xt = _bf16(x)
        tol = BF16
    else:
        xj, xt = jnp.asarray(x), torch.tensor(x)
        tol = dict(atol=1e-4, rtol=1e-4)     # fp32 cos/sin of angles ~1e3
    got = PL.apply_rope(xt, torch.tensor(pos), 500_000.0)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(
        _f32(got), _f32(JL.apply_rope(xj, jnp.asarray(pos), 500_000.0)),
        **tol)
    np.testing.assert_allclose(
        PL._rope_freqs(32, 500_000.0).numpy(),
        np.asarray(JL._rope_freqs(32, 500_000.0)), rtol=1e-6)


def test_ffn_apply():
    xj, xt = _bf16(rand((2, 5, 64), 6, 1.0))
    pj, pt = {}, {}
    for i, (name, shape) in enumerate([("w_gate", (64, 128)),
                                       ("w_up", (64, 128)),
                                       ("w_down", (128, 64))]):
        pj[name], pt[name] = _bf16(rand(shape, 10 + i, 0.125))
    np.testing.assert_allclose(_f32(PL.ffn_apply(pt, xt)),
                               _f32(JL.ffn_apply(pj, xj)), **BF16)


@pytest.mark.parametrize("cache_len", [1, 13, 20])
def test_decode_attention(cache_len):
    qj, qt = _bf16(rand((2, 1, 8, 32), 7, 1.0))
    kj, kt = _bf16(rand((2, 20, 2, 32), 8, 1.0))
    vj, vt = _bf16(rand((2, 20, 2, 32), 9, 1.0))
    got = PL.decode_attention(qt, kt, vt, cache_len)
    want = JL.decode_attention(qj, kj, vj, jnp.int32(cache_len))
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_local_window_raises():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PL.flash_attention(q, q, q, window=8)


@pytest.fixture(scope="module")
def gqa_block():
    """One attention block of the GQA-reduced config, in both packages."""
    jc, jp, pc, pp = lm_pair("gqa", seed=1)
    return jc, jax.tree.map(lambda a: a[0], jp["groups"]["b0"]), pc, \
        pp["layers"][0]


def _ctx(T, B=2, start=0, cache_index=0, cache_len=0):
    pos = np.arange(start, start + T, dtype=np.int32)[None].repeat(B, 0)
    return (JB.Ctx(positions=jnp.asarray(pos),
                   cache_index=jnp.int32(cache_index),
                   cache_len=jnp.int32(cache_len)),
            PB.Ctx(positions=torch.tensor(pos), cache_index=cache_index,
                   cache_len=cache_len))


def test_attn_apply(gqa_block):
    jc, jp, pc, pp = gqa_block
    xj, xt = _bf16(rand((2, 24, 64), 12, 1.0))
    cj, ct = _ctx(24)
    got = PB.attn_apply(pc, pp, xt, ct)
    want = JB.attn_apply(jc, jp, xj, cj)
    scale = float(np.abs(_f32(want)).max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                               atol=2e-2 * scale)


def test_attn_decode(gqa_block):
    """Three decode steps into a cache of 16, state carried in both."""
    jc, jp, pc, pp = gqa_block
    sj = JB.attn_init_state(jc, 2, 16)
    st = PB.attn_init_state(pc, 2, 16)
    for i in range(3):
        xj, xt = _bf16(rand((2, 1, 64), 30 + i, 1.0))
        cj, ct = _ctx(1, start=i, cache_index=i, cache_len=i + 1)
        want, sj = JB.attn_decode(jc, jp, xj, sj, cj)
        got, st2 = PB.attn_decode(pc, pp, xt, st, ct)
        assert st2 is st                       # the cache is written in place
        scale = float(np.abs(_f32(want)).max())
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                                   atol=2e-2 * scale)
        np.testing.assert_allclose(_f32(st.k), _f32(sj.k), **BF16)
        np.testing.assert_allclose(_f32(st.v), _f32(sj.v), **BF16)


def test_unported_options_raise():
    _, pc = lm_configs("reduced")
    for change in (dict(qk_norm=True), dict(kv_quant=True),
                   dict(rope="mrope")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PB.attn_defs(dataclasses.replace(pc, **change))
    for kind in ("local_attn", "moe", "rglru", "mlstm", "slstm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PB.block_defs(pc, kind)
