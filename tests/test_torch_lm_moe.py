"""MoE in the port (``repro_torch.models.blocks``): the GShard grouped
dispatch (``moe_ffn_grouped``), the flat sort-based one (``moe_ffn``), the
load-balancing loss and the moe block, against the JAX package on the
CPU; then phi3.5-moe and llama4-maverick as models: the parameter
hand-over of their expert leaves, the reduced models against
``tests/torch_lm_families_b.npz`` (``check_family_b``), the port's own
decode-versus-forward check and the serving CLI.

Tolerances: the blocks in fp32 at 1e-5 (the reference's own f32
tolerance, ``tests/models/test_optimizations.py``); the flat dispatch's
overflow of expert E - 1 exactly (``torch_parity.moe_overflow_case``:
inputs whose every product and sum is exact); the reduced models'
logits at ``LOGITS_TOL`` (atol 0.2 / rtol 0.05) with greedy tokens
equal; parameter bits exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as JB
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks as PB
from repro_torch.models import model as M
from torch_parity import (FAMILY_B_PARAMS, LOGITS_TOL, as_np, block_ctx,
                          both_trees, check_family_b, defs_params,
                          family_b_configs, family_b_pair, flatten,
                          moe_overflow_case, prompts, rand, tree_np,
                          unstacked_shapes)

F32 = dict(atol=1e-5, rtol=1e-5)
PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"


def _cfgs(arch, **moe):
    """``(jax cfg, port cfg)`` of the reduced ``arch`` with its MoE
    config changed by ``moe``."""
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                 for c in family_b_configs(arch))


def _moe_params(cfg, seed):
    return both_trees(defs_params(JB.moe_defs(cfg), seed))


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
@pytest.mark.parametrize("T", [24, 1000])
@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
@pytest.mark.parametrize("grouped", [True, False])
def test_dispatch_matches_jax(arch, T, cf, grouped):
    """Grouped (T 24: one group of 24 per request; T 1000: the group size
    halves from 256 to 8, capacity ``int(cf * 8 * k / E + 0.999)``) and
    flat dispatch, with and without capacity drops; llama4 adds the
    shared expert at top-1."""
    jc, pc = _cfgs(arch, capacity_factor=cf, grouped=grouped)
    jp, pp = _moe_params(jc, seed=1)
    x = rand((2, T, jc.d_model), seed=2, scale=1.0)
    if grouped:
        want, wp = JB.moe_ffn_grouped(jc, jp, jnp.asarray(x))
        got, gp = PB.moe_ffn_grouped(pc, pp, torch.tensor(x))
    else:
        want, wp = JB.moe_ffn(jc, jp, jnp.asarray(x.reshape(2 * T, -1)))
        got, gp = PB.moe_ffn(pc, pp, torch.tensor(x.reshape(2 * T, -1)))
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    np.testing.assert_allclose(as_np(gp), as_np(wp), **F32)
    if cf == 0.5:        # tokens dropped: the result moved off cf 4.0's
        ref = dict(capacity_factor=4.0, grouped=grouped)
        jr, _ = _cfgs(arch, **ref)
        full = (JB.moe_ffn_grouped(jr, jp, jnp.asarray(x))[0] if grouped
                else JB.moe_ffn(jr, jp, jnp.asarray(x.reshape(2 * T, -1)))[0])
        assert np.abs(as_np(full) - as_np(want)).max() > 1e-3


@pytest.mark.parametrize("counts", [(8, 6, 7, 11), (12, 6, 6, 8)])
def test_flat_overflow_of_last_expert_matches_jax_bit_for_bit(counts):
    """The reference's flat scatter: when expert E-1 overflows (8, 6, 7,
    11), its dropped rows are written after its kept row in slot (E-1,
    C-1) and zero it, so that kept token's output is zero; when only
    expert 0 overflows (12, 6, 6, 8), slot (E-1, C-1) keeps its row.  The
    inputs make every value exact, so the port equals the reference bit
    for bit."""
    moe, params, x, kept_last = moe_overflow_case(counts)
    jc, pc = _cfgs(PHI, **moe)
    jp, pp = both_trees(params)
    want, _ = JB.moe_ffn(jc, jp, jnp.asarray(x))
    got, _ = PB.moe_ffn(pc, pp, torch.tensor(x))
    np.testing.assert_array_equal(as_np(got), as_np(want))
    row = as_np(got)[kept_last]
    assert (not row.any()) == (counts[-1] > 8)
    assert np.count_nonzero(np.abs(as_np(got)).sum(1)) == \
        sum(min(c, 8) for c in counts) - (counts[-1] > 8)


def test_flat_overflow_at_top2_matches_jax():
    """The overflow at top-2: every token's first choice is expert E-1
    (capacity 0.5, C 8 of 16 tokens): token 7, the last kept one, loses
    expert E-1's contribution (its row is zeroed by the dropped tokens 8-15)
    and keeps only its second expert's."""
    jc, pc = _cfgs(PHI, capacity_factor=0.5, grouped=False)
    jp, pp = _moe_params(jc, seed=3)
    x = rand((16, jc.d_model), seed=4, scale=1.0)
    x[:, 0] = 8.0                  # feature 0 routes every token to expert 3
    router = np.asarray(jp["router"]).copy()
    router[0] = [0.0, 0.0, 0.0, 1.0]
    jp["router"], pp["router"] = jnp.asarray(router), torch.tensor(router)
    want, probs = JB.moe_ffn(jc, jp, jnp.asarray(x))
    got, _ = PB.moe_ffn(pc, pp, torch.tensor(x))
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    top = np.argsort(-np.asarray(probs), axis=1, kind="stable")[:, :2]
    assert (top[:, 0] == 3).all()
    # token 7: only its second expert's share is left
    pr = np.asarray(probs)[7]
    e2 = top[7, 1]
    g2 = pr[e2] / (pr[3] + pr[e2])
    h = torch.tensor(x[7:8])
    mlp = {k: pp[k][e2] for k in ("w_gate", "w_up", "w_down")}
    alone = g2 * PB.ffn_apply(mlp, h)[0].numpy()
    np.testing.assert_allclose(as_np(got)[7], alone, **F32)


@pytest.mark.parametrize("E", [4, 16])
def test_top_k_tie_order_under_a_zero_router(E):
    """A zero router makes every probability tie: ``jax.lax.top_k`` picks
    the lowest indices (``torch.topk`` need not), and the port's
    ``top_k`` does the same; both dispatches then match the reference."""
    jc, pc = _cfgs(PHI, num_experts=E, capacity_factor=4.0)
    jp, pp = _moe_params(jc, seed=5)
    jp["router"] = jnp.zeros_like(jp["router"])
    pp["router"] = torch.zeros_like(pp["router"])
    probs = torch.full((3, E), 1.0 / E)
    _, idx = PB.top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[0, 1]] * 3
    x = rand((2, 12, jc.d_model), seed=6, scale=1.0)
    for grouped in (True, False):
        jg, pg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, grouped=grouped)) for c in (jc, pc))
        want = JB.moe_apply(jg, jp | {"norm": jnp.zeros(jc.d_model)},
                            jnp.asarray(x), None)
        got = PB.moe_apply(pg, pp | {"norm": torch.zeros(jc.d_model)},
                           torch.tensor(x), None)
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)


def test_moe_aux_loss_matches_jax():
    jc, pc = _cfgs(PHI)
    logits = rand((64, 4), seed=7, scale=2.0)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = JB.moe_aux_loss(jnp.asarray(probs), jc)
    got = PB.moe_aux_loss(torch.tensor(probs), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_moe_block_prefill_and_decode_match_jax(arch):
    """The moe block (attention, then the experts in the MLP's place) in
    fp32: prefill output and aux loss, then three decode steps into its
    bf16 KV cache (the grouped dispatch at n = 1)."""
    jc, pc = family_b_configs(arch)
    jp, pp = both_trees(defs_params(JB.block_defs(jc, "moe"), seed=8))
    x = rand((2, 16, jc.d_model), seed=9, scale=1.0)
    cj, ct = block_ctx(16)
    want, waux, _ = JB.block_apply(jc, "moe", jp, jnp.asarray(x), cj)
    got, gaux, st, resid = PB.block_apply(pc, "moe", pp, torch.tensor(x), ct)
    assert st is None and resid is None
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(waux), **F32)
    sj = JB.block_init_state(jc, "moe", 2, 8)
    spt = PB.block_init_state(pc, "moe", 2, 8)
    for i in range(3):
        xi = rand((2, 1, jc.d_model), seed=10 + i, scale=1.0)
        cj, ct = block_ctx(1, start=i, cache_index=i, cache_len=i + 1)
        want, sj = JB.block_decode(jc, "moe", jp, jnp.asarray(xi), sj, cj)
        got, spt, _ = PB.block_decode(pc, "moe", pp, torch.tensor(xi), spt,
                                      ct)
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
        np.testing.assert_array_equal(spt.k.float().numpy(),
                                      np.asarray(sj.k, np.float32))


def test_full_width_parameter_counts_and_shapes():
    """phi3.5-moe and llama4-maverick at full width: total and active
    parameter counts equal the reference's, and the port's per-layer
    shapes are the reference's stacked ones unstacked (nothing is
    allocated)."""
    from repro.models import param_defs as jax_param_defs
    from repro_torch.configs import get_arch
    from repro.configs import get_arch as jax_arch
    for arch in (PHI, LLAMA4):
        jc, pc = jax_arch(arch), get_arch(arch)
        assert (pc.param_count(), pc.active_param_count()) == \
            FAMILY_B_PARAMS[arch] == (jc.param_count(),
                                      jc.active_param_count())
        want = unstacked_shapes(jax_param_defs(jc), jc)
        got = {k: d.shape for k, d in flatten(
            {"layers": dict(enumerate(M.param_defs(pc)["layers"])),
             **{k: v for k, v in M.param_defs(pc).items()
                if k != "layers"}}).items()}
        assert got == want


@pytest.mark.parametrize("arch,n_layers", [(PHI, 3), (LLAMA4, 4)])
def test_convert_round_trip_expert_leaves(arch, n_layers):
    """The stacked ``(G, E, d, ff)`` expert leaves and router of
    phi3.5-moe, llama4's shared expert and its attention layers'
    ``d_ff_dense`` MLP: unstacked and stacked back bit for bit."""
    jc, jp, pc, pp = family_b_pair(arch, seed=3, n_layers=n_layers)
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if arch == PHI:
        assert want["groups.b0.moe.w_gate"].shape == (3, 4, 64, 64)
        assert want["groups.b0.moe.router"].shape == (3, 64, 4)
        np.testing.assert_array_equal(
            convert.bf16_bits(pp["layers"][2]["moe"]["w_down"]),
            want["groups.b0.moe.w_down"][2])
    else:
        assert want["groups.b1.moe.shared.w_up"].shape == (2, 64, 64)
        assert want["groups.b0.mlp.w_gate"].shape == (2, 64, 16_384)
        np.testing.assert_array_equal(
            convert.bf16_bits(pp["layers"][3]["moe"]["shared"]["w_up"]),
            want["groups.b1.moe.shared.w_up"][1])
        np.testing.assert_array_equal(
            convert.bf16_bits(pp["layers"][2]["mlp"]["w_down"]),
            want["groups.b0.mlp.w_down"][1])


@pytest.mark.parametrize("entry", [PHI, PHI + "+cf1", LLAMA4])
def test_port_matches_families_b_fixture(entry):
    """What ``chip_smoke.py`` phase 20 checks on the card, here on the
    CPU (``+cf1``: capacity 1.0, tokens dropped in prefill)."""
    check_family_b(entry)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_forward_aux_loss_matches_jax(arch):
    """``forward`` sums the moe layers' load-balancing losses, as the JAX
    package's does (its router probabilities are fp32 functions of the
    bf16 residual stream)."""
    from repro.models import Batch as JBatch
    from repro.models import forward as jax_forward
    jc, jp, pc, pp = family_b_pair(arch, seed=6)
    pr = prompts(jc, 2, 20, seed=7)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    _, want = jax_forward(jc, jp, JBatch(tokens=jnp.asarray(pr),
                                         positions=jnp.asarray(pos)))
    _, got = M.forward(pc, pp, M.Batch(tokens=torch.tensor(pr),
                                       positions=torch.tensor(pos)))
    assert float(want) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_decode_matches_forward(arch):
    """The port alone: prefill(T) + decode(token T) == forward over T+1
    (the reduced configs' capacity 4.0 drops nothing)."""
    pc = family_b_configs(arch)[1]
    pp = M.init_params(pc, 2, device="cpu")
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, aux = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    assert float(aux) > 0
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=T + 1)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_launch_serve_cli_prints_active_parameters(capsys):
    toks = launch_serve.main(["--arch", PHI, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "12",
                              "--max-new", "3"])
    assert toks.shape == (2, 3)
    out = capsys.readouterr().out
    assert f"arch={PHI}-reduced" in out and "params=164,672 active=115,520" \
        in out
