"""xLSTM in the port (``repro_torch.models.blocks``): the mLSTM and sLSTM
cells and blocks against the JAX package on the CPU, then xlstm-350m as a
model: its full-width shapes and count, the parameter hand-over of
``r_zifo`` and ``w_if``, the reduced model against
``tests/torch_lm_families_b.npz`` (``check_family_b``: every layer in the
reference's compiled scan), a model with a remainder layer the reference
runs op by op, and the port's own decode-versus-forward check.

Tolerances: cells and blocks in fp32 at 1e-5 (the reference's own f32
tolerance); the models' logits at ``LOGITS_TOL`` (atol 0.2 / rtol 0.05);
parameter bits exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Batch as JBatch
from repro.models import blocks as JB
from repro.models import forward as jax_forward
from repro.models.model import last_logits as jax_last_logits
from repro_torch import convert
from repro_torch.models import blocks as PB
from repro_torch.models import model as M
from torch_parity import (FAMILY_B_PARAMS, LOGITS_TOL, as_np, block_ctx,
                          both_trees, check_family_b, defs_params,
                          family_b_configs, family_b_pair, flatten, prompts,
                          rand, tree_np, unstacked_shapes)

F32 = dict(atol=1e-5, rtol=1e-5)
NAME = "xlstm-350m"


@pytest.fixture(scope="module")
def cfgs():
    return family_b_configs(NAME)


def _state(kind, cfg, seed):
    """A random fp32 recurrent state of ``kind`` for batch 2 (``m`` near
    the gates' range, the normaliser positive)."""
    H, hd = cfg.n_heads, cfg.head_dim
    if kind == "mlstm":
        tree = dict(C=rand((2, H, hd, hd), seed), n=rand((2, H, hd), seed + 1),
                    m=rand((2, H), seed + 2, 2.0))
        return (JB.MLSTMState(**both_trees(tree)[0]),
                PB.MLSTMState(**both_trees(tree)[1]))
    tree = dict(c=rand((2, H, hd), seed), h=rand((2, H, hd), seed + 1),
                n=np.abs(rand((2, H, hd), seed + 2)) + 0.5,
                m=rand((2, H, hd), seed + 3, 2.0))
    return JB.SLSTMState(**both_trees(tree)[0]), PB.SLSTMState(**both_trees(tree)[1])


def _close_states(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **F32)


def test_mlstm_cell_matches_jax(cfgs):
    jc, _ = cfgs
    H, hd = jc.n_heads, jc.head_dim
    for step in range(3):
        sj, st = _state("mlstm", jc, 10 * step)
        q, k, v = (rand((2, H, hd), 100 + 10 * step + i) for i in range(3))
        i_log, f_log = rand((2, H), 5 + step, 2.0), \
            -np.abs(rand((2, H), 6 + step))
        want_s, want = JB._mlstm_cell(sj, *map(jnp.asarray,
                                               (q, k, v, i_log, f_log)))
        got_s, got = PB._mlstm_cell(st, *map(torch.tensor,
                                             (q, k, v, i_log, f_log)))
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
        _close_states(got_s, want_s)


def test_slstm_cell_matches_jax(cfgs):
    jc, _ = cfgs
    H, hd = jc.n_heads, jc.head_dim
    r = rand((H, hd, 4 * hd), 7, 0.2)
    for step in range(3):
        sj, st = _state("slstm", jc, 10 * step)
        zifo = rand((2, H, 4 * hd), 8 + step, 1.0)
        want_s, want = JB._slstm_cell(sj, jnp.asarray(zifo), jnp.asarray(r))
        got_s, got = PB._slstm_cell(st, torch.tensor(zifo), torch.tensor(r))
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
        _close_states(got_s, want_s)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_jax(cfgs, kind):
    """A block in fp32: prefill over 12 tokens with its final state, then
    three decode steps from that state."""
    jc, pc = cfgs
    jp, pp = both_trees(defs_params(JB.block_defs(jc, kind), seed=11))
    x = rand((2, 12, jc.d_model), seed=12, scale=1.0)
    cj, ct = block_ctx(12)
    want, _, sj = JB.block_apply(jc, kind, jp, jnp.asarray(x), cj,
                                 with_state=True)
    got, aux, st, _ = PB.block_apply(pc, kind, pp, torch.tensor(x), ct,
                                     with_state=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    _close_states(st, sj)
    for i in range(3):
        xi = rand((2, 1, jc.d_model), seed=13 + i, scale=1.0)
        cj, ct = block_ctx(1, start=12 + i, cache_index=12 + i,
                      cache_len=13 + i)
        want, sj = JB.block_decode(jc, kind, jp, jnp.asarray(xi), sj, cj)
        got, st, _ = PB.block_decode(pc, kind, pp, torch.tensor(xi), st, ct)
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
        _close_states(st, sj)
    fresh = PB.block_init_state(pc, kind, 2, 0)
    _close_states(fresh, JB.block_init_state(jc, kind, 2, 0))


def test_full_width_parameter_count_and_shapes():
    from repro.configs import get_arch as jax_arch
    from repro.models import param_defs as jax_param_defs
    from repro_torch.configs import get_arch
    jc, pc = jax_arch(NAME), get_arch(NAME)
    assert (pc.param_count(), pc.active_param_count()) == \
        FAMILY_B_PARAMS[NAME] == (jc.param_count(), jc.active_param_count())
    defs = M.param_defs(pc)
    got = {k: d.shape for k, d in flatten(
        {"layers": dict(enumerate(defs["layers"])),
         **{k: v for k, v in defs.items() if k != "layers"}}).items()}
    assert got == unstacked_shapes(jax_param_defs(jc), jc)
    assert got["layers.1.r_zifo"] == (4, 256, 1024)
    assert got["layers.0.w_if"] == (1024, 8)


def test_convert_round_trip_recurrent_leaves():
    """``r_zifo`` (H, hd, 4 hd) and ``w_if`` (d, 2 H), stacked over 3
    groups of (mLSTM, sLSTM) and a remainder mLSTM: unstacked and stacked
    back bit for bit."""
    jc, jp, pc, pp = family_b_pair(NAME, seed=3, n_layers=7)
    assert (jc.n_groups(), jc.n_remainder()) == (3, 1)
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["groups.b1.r_zifo"].shape == (3, 2, 32, 128)
    np.testing.assert_array_equal(convert.bf16_bits(pp["layers"][5]["r_zifo"]),
                                  want["groups.b1.r_zifo"][2])
    np.testing.assert_array_equal(convert.bf16_bits(pp["layers"][6]["w_if"]),
                                  want["rem.r0.w_if"])


def test_port_matches_families_b_fixture():
    check_family_b(NAME)


def test_remainder_layer_op_by_op_matches_jax():
    """Three layers: one scanned (mLSTM, sLSTM) group and a remainder
    mLSTM, which the reference runs op by op (``fused=False`` in the
    port): last-position logits within ``LOGITS_TOL``."""
    jc, jp, pc, pp = family_b_pair(NAME, seed=4, n_layers=3)
    assert pc.n_remainder() == 1
    B, T = 2, 20
    pr = prompts(jc, B, T, seed=5)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    xj, _ = jax_forward(jc, jp, JBatch(tokens=jnp.asarray(pr),
                                       positions=jnp.asarray(pos)))
    want = np.asarray(jax_last_logits(jc, jp, xj))
    xt, _ = M.forward(pc, pp, M.Batch(tokens=torch.tensor(pr),
                                      positions=torch.tensor(pos)))
    np.testing.assert_allclose(M.last_logits(pc, pp, xt).numpy(), want,
                               **LOGITS_TOL)


def test_decode_matches_forward(cfgs):
    """The port alone: prefill(T) + decode(token T) == forward over T+1,
    the recurrent states carried from prefill."""
    pc = cfgs[1]
    pp = M.init_params(pc, 2, device="cpu")
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=T + 1)
    assert [type(s).__name__ for s in states] == \
        ["MLSTMState", "SLSTMState"] * 2
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)
