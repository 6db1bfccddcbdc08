"""The qk-norm dense family (qwen3-4b, qwen3-14b) and glm4-9b in the port
(``repro_torch.models``) against the JAX package on the CPU: configs,
full-width parameter shapes and counts (from shapes, nothing allocated),
``_qkv`` with the per-head RMSNorm, the parameter hand-over with the
``q_norm``/``k_norm`` leaves, the port's decode-versus-forward, and the
reduced models' prefill and teacher-forced decode logits and greedy
``serve_batch`` tokens against their part of
``tests/torch_lm_families.npz`` (the JAX package's;
``test_torch_lm_families_fixture.py`` keeps it current; ``chip_smoke.py``
phase 19 holds the card to it).

Logits are compared at ``LOGITS_TOL`` (atol 0.2, rtol 0.05), the JAX
package's own decode-parity tolerance; greedy tokens exactly; a single
``_qkv`` in bf16 at 2e-2, the reference's bf16 tolerance (the two packages
round bf16 at other places inside RoPE's fp32 chain)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as JB
from repro.models import param_defs as jax_param_defs
from repro.models.model import count_params as jax_count_params
from repro_torch import convert
from repro_torch.models import blocks as PB
from repro_torch.models import model as M
from repro_torch.models.layers import ParamTree
from repro_torch.serve.step import serve_batch
from test_torch_lm_model import _port_prefill_and_decode
from torch_parity import (FAMILY_PARAMS, LM_FAMILIES_FIXTURE, LOGITS_TOL,
                          family_configs, family_pair, flatten,
                          load_lm_family, prompts, rand, tree_np,
                          unstacked_shapes)

NAMES = ["qwen3-4b", "qwen3-14b", "glm4-9b"]


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name):
    for full in (True, False):
        jc, pc = family_configs(name, full=full)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    jc, pc = family_configs(name, full=True)
    assert pc.qk_norm == (name != "glm4-9b")
    assert pc.block_pattern == ("attn",) and pc.head_dim == 128


@pytest.mark.parametrize("name", NAMES)
def test_full_width_param_shapes_and_count(name):
    jc, pc = family_configs(name, full=True)
    module = ParamTree(M.param_defs(pc), device="meta")   # no storage
    got = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert got == unstacked_shapes(jax_param_defs(jc), jc)
    if pc.qk_norm:
        assert got["layers.0.q_norm"] == got["layers.0.k_norm"] == (128,)
    n = FAMILY_PARAMS[name]
    assert sum(p.numel() for p in module.parameters()) == n
    assert M.count_params(pc) == pc.param_count() == jax_count_params(jc) == n


@pytest.mark.parametrize("name", ["qwen3-4b", "glm4-9b"])
def test_qkv(name):
    """q, k, v of one layer (qk-norm per head before RoPE for qwen3) with
    nonzero norm scales."""
    jc, pc = family_configs(name)
    B, T, d = 2, 9, jc.d_model
    arrs = {"wq": (d, jc.d_qkv), "wk": (d, jc.d_kv), "wv": (d, jc.d_kv),
            "q_norm": (jc.head_dim,), "k_norm": (jc.head_dim,)}
    pj, pt = {}, {}
    for i, (k, shape) in enumerate(arrs.items()):
        a = rand(shape, 20 + i, 0.125 if len(shape) == 2 else 0.5)
        pj[k], pt[k] = jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
    x = rand((B, T, d), 30, 1.0)
    pos = np.arange(5, 5 + T, dtype=np.int32)[None].repeat(B, 0)
    cj = JB.Ctx(positions=jnp.asarray(pos), cache_index=jnp.int32(0),
                cache_len=jnp.int32(0))
    ct = PB.Ctx(positions=torch.tensor(pos), cache_index=0, cache_len=0)
    got = PB._qkv(pc, pt, torch.tensor(x).bfloat16(), ct)
    want = JB._qkv(jc, pj, jnp.asarray(x, jnp.bfloat16), cj, False)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=2e-2,
                                   rtol=2e-2)


def test_convert_round_trip_with_qk_norm_leaves():
    jc, jp, pc, pp = family_pair("qwen3-4b", seed=3)
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    assert want["groups.b0.q_norm"].shape == (jc.n_groups(), jc.head_dim)
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        convert.bf16_bits(pp["layers"][1]["k_norm"]),
        want["groups.b0.k_norm"][1])


def test_decode_matches_forward():
    """The port alone: prefill(T) + decode(token T) == forward over T+1."""
    _, _, pc, pp = family_pair("qwen3-4b", seed=7)
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=T + 4)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_port_matches_families_fixture(name):
    """What chip_smoke.py phase 19 checks on the card, here on the CPU."""
    z = np.load(LM_FAMILIES_FIXTURE)
    pc, pp, arrs = load_lm_family(z, name, "cpu")
    assert dataclasses.asdict(pc) == dataclasses.asdict(
        family_configs(name)[1])
    pr, n = arrs["prompts"], arrs["tokens"].shape[1]
    toks, first = serve_batch(pc, pp, pr, n, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), arrs["tokens"])
    np.testing.assert_array_equal(first.numpy(), arrs["first"])
    seq = np.concatenate([arrs["first"][:, None], arrs["tokens"]], 1)
    got = _port_prefill_and_decode(pc, pp, pr, seq, n)
    np.testing.assert_allclose(got[0], arrs["prefill_logits"], **LOGITS_TOL)
    np.testing.assert_allclose(np.stack(got[1:], 1), arrs["decode_logits"],
                               **LOGITS_TOL)
