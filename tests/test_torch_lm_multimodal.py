"""M-RoPE with the vision stub (qwen2-vl-72b) and the audio stub
(musicgen-medium) in the port, against the JAX package on the CPU:
``apply_mrope`` (and its equality with RoPE on text positions), the two
frontends' embeddings, the audio head, the reduced models against
``tests/torch_lm_families_b.npz`` (``check_family_b``; qwen2-vl's entry
also holds a forward with ``vis_embeds``), ``serve_batch``'s M-RoPE
positions and audio shapes, the port's own decode-versus-forward check,
the musicgen parameter hand-over and the serving CLI with an audio
config.

Tolerances: ``apply_mrope`` in fp32 at 1e-5 (the reference's own f32
tolerance); embeddings bit for bit; the audio head in fp32 at 1e-5; the
models' logits at ``LOGITS_TOL`` (atol 0.2 / rtol 0.05) with greedy
tokens equal; parameter bits exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Batch as JBatch
from repro.models import layers as JL
from repro.models.model import embed_input as jax_embed_input
from repro.models.model import last_logits as jax_last_logits
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as PL
from repro_torch.models import model as M
from repro_torch.serve.step import mrope_positions, serve_batch
from torch_parity import (FAMILY_B_PARAMS, LOGITS_TOL, as_np, check_family_b,
                          family_b_configs, family_b_pair, flatten,
                          positions, prompts, rand, tree_np, vis_embeds)

F32 = dict(atol=1e-5, rtol=1e-5)
VL, AUDIO = "qwen2-vl-72b", "musicgen-medium"


@pytest.mark.parametrize("D", [32, 128, 20])
def test_apply_mrope_matches_jax(D):
    """Three position streams of their own; D 32 and 20 rescale the
    (16, 24, 24) sections to half 16 and 10 (the rounding to the last)."""
    x = rand((2, 9, 3, D), seed=1, scale=1.0)
    rng = np.random.default_rng(2)
    pos3 = rng.integers(0, 4000, (2, 9, 3)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
        got = PL.apply_mrope(torch.tensor(x), torch.tensor(pos3), theta)
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    xb = torch.tensor(x).bfloat16()
    got = PL.apply_mrope(xb, torch.tensor(pos3))
    want = JL.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos3))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-2, rtol=2e-2)


def test_mrope_equals_rope_on_text_positions():
    """With the same position in all three streams M-RoPE is RoPE (the
    reference's ``tests/models/test_components.py``), in both
    packages."""
    x = rand((2, 7, 4, 64), seed=3, scale=1.0)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 100
    pos3 = np.stack([pos] * 3, -1)
    rope = PL.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    mrope = PL.apply_mrope(torch.tensor(x), torch.tensor(pos3), 1e6)
    np.testing.assert_allclose(mrope.numpy(), rope.numpy(), atol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(mrope.numpy(), np.asarray(want), **F32)


@pytest.fixture(scope="module")
def vl_pair():
    return family_b_pair(VL, seed=1)


@pytest.fixture(scope="module")
def audio_pair():
    return family_b_pair(AUDIO, seed=1)


def test_embeddings_match_jax_bit_for_bit(vl_pair, audio_pair):
    """The vision stub overwrites the first T / VIS_FRAC positions; the
    audio stub sums the K codebook embeddings in codebook order in
    bf16."""
    jc, jp, pc, pp = vl_pair
    pr, ve = prompts(jc, 2, 24, seed=4), vis_embeds(jc, 2, 24, seed=5)
    assert ve.shape == (2, 24 // M.VIS_FRAC, jc.d_model)
    pos = positions(jc, 2, 24)
    want = jax_embed_input(jc, jp, JBatch(
        tokens=jnp.asarray(pr), positions=jnp.asarray(pos),
        vis_embeds=jnp.asarray(ve, jnp.bfloat16)))
    got = M.embed_input(pc, pp, M.Batch(
        tokens=torch.tensor(pr), positions=torch.tensor(pos),
        vis_embeds=torch.tensor(ve).bfloat16()))
    np.testing.assert_array_equal(as_np(got), as_np(want))
    np.testing.assert_array_equal(as_np(got)[:, :3], ve)
    jc, jp, pc, pp = audio_pair
    pr = prompts(jc, 2, 24, seed=6)
    assert pr.shape == (2, 24, 4)
    want = jax_embed_input(jc, jp, JBatch(tokens=jnp.asarray(pr),
                                          positions=None))
    got = M.embed_input(pc, pp, M.Batch(tokens=torch.tensor(pr),
                                        positions=None))
    np.testing.assert_array_equal(as_np(got), as_np(want))


def test_audio_head_matches_jax(audio_pair):
    """One fp32 head per codebook: (B, 1, K, V)."""
    jc, jp, pc, pp = audio_pair
    x = rand((2, 5, jc.d_model), seed=7, scale=1.0)
    want = jax_last_logits(jc, jp, jnp.asarray(x, jnp.bfloat16))
    got = M.last_logits(pc, pp, torch.tensor(x).bfloat16())
    assert got.shape == (2, 1, 4, jc.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("entry", [VL, AUDIO])
def test_port_matches_families_b_fixture(entry):
    check_family_b(entry)


def test_serve_batch_mrope_positions_and_audio_shapes(audio_pair):
    """``serve_batch`` hands an M-RoPE config ``(p, p // 7, p % 7)`` in
    prefill and decode; an audio config takes (B, T, K) prompts and
    returns tokens (B, max_new, K) and ``first`` (B, K)."""
    pos = torch.arange(20, dtype=torch.int32)[None]
    p3 = mrope_positions(pos)
    assert p3.shape == (1, 20, 3)
    assert p3[0, 15].tolist() == [15, 2, 1]
    np.testing.assert_array_equal(p3.numpy(), positions(
        family_b_configs(VL)[1], 1, 20))
    _, _, pc, pp = audio_pair
    toks, first = serve_batch(pc, pp, prompts(pc, 2, 10, seed=8), 3,
                              device="cpu")
    assert toks.shape == (2, 3, 4) and first.shape == (2, 4)
    assert toks.dtype == torch.int32


@pytest.mark.parametrize("entry", [VL, AUDIO])
def test_decode_matches_forward(entry):
    """The port alone: prefill(T) + decode(token T) == forward over T+1
    (M-RoPE triples; audio tokens (B, T, K))."""
    pc = family_b_configs(entry)[1]
    pp = M.init_params(pc, 2, device="cpu")
    B, T = 2, 16
    toks = torch.tensor(prompts(pc, B, T + 1, seed=8))
    pos = torch.tensor(positions(pc, B, T + 1))
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=T + 1)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_full_width_parameter_counts():
    from repro_torch.configs import get_arch
    for arch in (VL, AUDIO):
        cfg = get_arch(arch)
        assert (cfg.param_count(), cfg.active_param_count()) == \
            FAMILY_B_PARAMS[arch]
    defs = M.param_defs(get_arch(AUDIO))
    assert defs["embed"].shape == (4, 2048, 1536)
    assert defs["unembed"].shape == (4, 1536, 2048)


def test_convert_round_trip_codebook_leaves(audio_pair):
    """musicgen's top-level (K, V, D) embed and (K, D, V) unembed (and its
    stacked layers): bit for bit both ways."""
    jc, jp, pc, pp = audio_pair
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    assert want["embed"].shape == (4, 256, 64)
    assert want["unembed"].shape == (4, 64, 256)
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launch_serve_cli_audio_prompts(capsys):
    """The CLI draws (B, T, K) prompts for an audio config."""
    toks = launch_serve.main(["--arch", AUDIO, "--reduced", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "12",
                              "--max-new", "3"])
    assert toks.shape == (2, 3, 4)
    out = capsys.readouterr().out
    assert f"arch={AUDIO}-reduced" in out and "active=" not in out


def test_vision_stub_is_optional_in_forward(vl_pair):
    """Without ``vis_embeds`` the vision config runs as text (as
    ``serve_batch`` serves it, like the reference's)."""
    _, _, pc, pp = vl_pair
    pr = torch.tensor(prompts(pc, 2, 8, seed=9))
    pos = torch.tensor(positions(pc, 2, 8))
    x, _ = M.forward(pc, pp, M.Batch(tokens=pr, positions=pos))
    y, _ = M.forward(dataclasses.replace(pc, frontend=None), pp,
                     M.Batch(tokens=pr, positions=pos))
    torch.testing.assert_close(x, y, atol=0, rtol=0)
