"""The int8 KV cache (``cfg.kv_quant``) in the port, against the JAX
package on the CPU: ``kv_quantize``'s codes and scales and
``kv_dequantize`` bit for bit, the quantised prefill cache and a decode
step's in-place write bit for bit (both packages handed the same k and
v), the cache's bytes, the reduced llama3.2-1b with the int8 cache
against ``tests/torch_lm_families_b.npz`` (``check_family_b``) and the
port's own decode-versus-forward check.

Tolerances: codes, scales and caches exactly; logits at ``LOGITS_TOL``
(atol 0.2 / rtol 0.05) with greedy tokens equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch.models import blocks as PB
from repro_torch.models import model as M
from torch_parity import (LOGITS_TOL, as_np, block_ctx, check_family_b,
                          family_b_configs, prompts, rand)

ENTRY = "llama3.2-1b+kv_quant"


def _kv(seed, shape=(2, 5, 2, 32)):
    """bf16 k/v values with an all-zero row and a row whose scale is
    exactly 1 and that holds the ties 2.5, -3.5 and 0.5 (half to
    even)."""
    x = rand(shape, seed, scale=1.0)
    rows = x.reshape(-1, shape[-1])          # (position, head) rows
    rows[0] = 0.0
    rows[1, :4] = [127.0, 2.5, -3.5, 0.5]
    rows[1, 4:] = 0.25
    return torch.tensor(x).bfloat16().float().numpy()


def test_kv_quantize_codes_and_scales_bit_for_bit():
    for seed in range(3):
        x = _kv(seed)
        for dt in (jnp.bfloat16, jnp.float32):
            wq, ws = JB.kv_quantize(jnp.asarray(x, dt))
            gq, gs = PB.kv_quantize(torch.tensor(x).to(
                torch.bfloat16 if dt == jnp.bfloat16 else torch.float32))
            assert gq.dtype == torch.int8 and gs.dtype == torch.float32
            np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
            np.testing.assert_array_equal(gs.numpy().view(np.uint32),
                                          np.asarray(ws).view(np.uint32))
        assert gq[0, 0, 1, :4].tolist() == [127, 2, -4, 0]
        assert not gq[0, 0, 0].any() and float(gs[0, 0, 0]) == \
            np.float32(1e-6) / np.float32(127)
        wd = JB.kv_dequantize(wq, ws)
        gd = PB.kv_dequantize(gq, gs)
        assert gd.dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(gd), as_np(wd))


def _same_qkv(monkeypatch, k, v):
    """Both packages' ``_qkv`` return these k and v (bf16), so the cache
    layout and quantisation are compared on equal inputs."""
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    kt, vt = torch.tensor(k).bfloat16(), torch.tensor(v).bfloat16()
    monkeypatch.setattr(JB, "_qkv", lambda *a, **kw: (None, kj, vj))
    monkeypatch.setattr(PB, "_qkv", lambda *a, **kw: (None, kt, vt))


@pytest.mark.parametrize("local,T,cache_len", [
    (False, 10, 14), (True, 10, 14), (True, 21, 24), (True, 19, 24)])
def test_quantised_prefill_cache_bit_for_bit(monkeypatch, local, T,
                                             cache_len):
    """The prefix's k/v quantised into the cache: a global cache of
    ``cache_len`` slots, and a local ring of window 8 slots the prompt
    wraps (T 21 and 19: roll by T % 8)."""
    jc, pc = (dataclasses.replace(c, kv_quant=True, attn_window=8)
              for c in family_b_configs("llama3.2-1b+kv_quant"))
    shape = (2, T, pc.n_kv_heads, pc.head_dim)
    _same_qkv(monkeypatch, _kv(1, shape), _kv(2, shape))
    x = rand((2, T, pc.d_model), 3, 1.0)
    cj, ct = block_ctx(T)
    sj = JM._prefill_attn_state(jc, {"norm": jnp.zeros(pc.d_model)}, cj,
                                jnp.asarray(x, jnp.bfloat16), cache_len,
                                local=local)
    st = M._prefill_attn_state(pc, {"norm": torch.zeros(pc.d_model)}, ct,
                               torch.tensor(x).bfloat16(), cache_len,
                               local=local)
    assert type(st).__name__ == "QuantAttnState"
    assert st.k.shape[1] == (8 if local else cache_len)
    for g, w in zip(st, sj):
        np.testing.assert_array_equal(as_np(g), as_np(w))


def test_decode_write_in_place_bit_for_bit(monkeypatch):
    """Three decode steps into a quantised cache: the codes and scales
    written at the step's slot, in place, equal the reference's; the
    attention output (over the dequantised cache) within bf16
    rounding."""
    jc, pc = family_b_configs(ENTRY)
    sj = JB.attn_init_state(jc, 2, 6)
    st = PB.attn_init_state(pc, 2, 6)
    shape = (2, 1, pc.n_kv_heads, pc.head_dim)
    for i in range(3):
        k, v = _kv(10 + i, shape), _kv(20 + i, shape)
        q = _kv(30 + i, (2, 1, pc.n_heads, pc.head_dim))
        cj, ct = block_ctx(1, start=i, cache_index=i, cache_len=i + 1)
        wo, sj = JB._cache_update_attend(jc, jnp.asarray(q, jnp.bfloat16),
                                         jnp.asarray(k, jnp.bfloat16),
                                         jnp.asarray(v, jnp.bfloat16), sj,
                                         cj, False)
        go, st2 = PB._cache_update_attend(pc, torch.tensor(q).bfloat16(),
                                          torch.tensor(k).bfloat16(),
                                          torch.tensor(v).bfloat16(), st,
                                          ct, False)
        assert st2 is st
        for g, w in zip(st, sj):
            np.testing.assert_array_equal(as_np(g), as_np(w))
        np.testing.assert_allclose(as_np(go), as_np(wo), atol=2e-2,
                                   rtol=2e-2)


def test_int8_cache_bytes_under_0_6_of_bf16():
    """As the reference's ``test_int8_kv_cache_memory_halves``: at head
    dim 64 (llama3.2-1b) the int8 cache with its fp32 scales takes (64 +
    4) / 128 = 0.53 of the bf16 cache's bytes."""
    from repro_torch.configs import get_arch
    cfg = get_arch("llama3.2-1b")
    nbytes = lambda c: sum(t.numel() * t.element_size()
                           for st in M.init_cache(c, 4, 1032, device="meta")
                           for t in st)
    q, b = nbytes(dataclasses.replace(cfg, kv_quant=True)), nbytes(cfg)
    assert q / b == pytest.approx(68 / 128) and q / b < 0.6


def test_port_matches_families_b_fixture():
    check_family_b(ENTRY)


def test_decode_matches_forward():
    """The port alone: prefill(T) + decode(token T) with the int8 cache
    == forward over T+1."""
    pc = family_b_configs(ENTRY)[1]
    pp = M.init_params(pc, 2, device="cpu")
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=T + 1)
    assert all(s.k.dtype == torch.int8 for s in states)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)
