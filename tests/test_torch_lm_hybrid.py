"""The hybrid recurrentgemma-2b in the port (``repro_torch.models``):
RG-LRU blocks and local attention with its ring KV cache, against the
JAX package on the CPU: the parameter hand-over of the 26-layer tree (8 x
(R, R, A) plus an (R, R) remainder), the reduced model's prefill and
teacher-forced decode logits and greedy ``serve_batch`` tokens against its part of
``tests/torch_lm_families.npz`` (the JAX package's, with the ring
wrapping in prefill and decode; ``test_torch_lm_families_fixture.py``
keeps it current; ``chip_smoke.py`` phase 19 holds the card to it), the
port's own decode-versus-forward and ring-buffer checks, and the serving
CLI.  The blocks alone: ``test_torch_lm_hybrid_blocks.py``.

Logits are compared at ``LOGITS_TOL`` (atol 0.2, rtol 0.05), the JAX
package's decode-parity tolerance; greedy tokens and parameter bits
exactly."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve.step import serve_batch
from test_torch_lm_model import _port_prefill_and_decode
from torch_parity import (LM_FAMILIES_FIXTURE, LOGITS_TOL, family_configs,
                          family_pair, flatten, load_lm_family, prompts,
                          tree_np)

NAME = "recurrentgemma-2b"


@pytest.fixture(scope="module")
def port():
    """The reduced config and seed-made port parameters (the port's own
    checks need no JAX)."""
    pc = family_configs(NAME)[1]
    return pc, M.init_params(pc, 2, device="cpu")


def test_convert_round_trip_26_layers():
    """recurrentgemma-2b's tree at full depth (8 x (R, R, A) + (R, R)) at
    reduced width: unstacked and stacked back bit for bit."""
    jc, jp, pc, pp = family_pair(NAME, seed=3, n_layers=26)
    assert (jc.n_groups(), jc.n_remainder()) == (8, 2)
    want = {k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(jp)).items()}
    assert want["groups.b0.conv_w"].shape == (8, 4, 64)
    assert want["rem.r1.a_log"].shape == (64,)
    assert "rem.r0.w_gate_a" in want and "rem.r2.wq" not in want
    got = flatten(convert.lm_params_to_numpy(pp, pc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kinds = pc.pattern_layers()
    assert kinds[24:] == ["rglru", "rglru"] and kinds[23] == "local_attn"
    np.testing.assert_array_equal(convert.bf16_bits(pp["layers"][25]["a_log"]),
                                  want["rem.r1.a_log"])
    np.testing.assert_array_equal(convert.bf16_bits(pp["layers"][4]["conv_w"]),
                                  want["groups.b1.conv_w"][1])


def _decode_vs_forward(pc, pp, T, cache_len, seed):
    B = 1
    toks = torch.tensor(prompts(pc, B, T + 1, seed=seed))
    pos = torch.arange(T + 1, dtype=torch.int32)[None].repeat(B, 1)
    x, _ = M.forward(pc, pp, M.Batch(tokens=toks, positions=pos))
    want = M.last_logits(pc, pp, x)
    _, _, states = M.forward(pc, pp, M.Batch(tokens=toks[:, :T],
                                             positions=pos[:, :T]),
                             return_states=True, cache_len=cache_len)
    got, _ = M.decode_step(pc, pp, states, M.Batch(
        tokens=toks[:, T:], positions=pos[:, T:], cache_index=T,
        cache_len=T + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_decode_matches_forward(port):
    """The port alone: prefill(T) + decode(token T) == forward over T+1."""
    _decode_vs_forward(*port, 16, 20, seed=8)


def test_local_attention_ring_buffer(port):
    """As the reference's test: a prompt of window + 9 tokens, one decode
    step; the ring keeps only the last ``window`` tokens and still
    matches a full forward."""
    pc, pp = port
    T = pc.attn_window + 9
    _decode_vs_forward(pc, pp, T, T + 4, seed=5)


def test_launch_serve_cli_on_cpu(capsys):
    toks = launch_serve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "70",
                              "--max-new", "3"])
    assert toks.shape == (2, 3)
    out = capsys.readouterr().out
    assert f"arch={NAME}-reduced" in out and "params=" in out


def test_port_matches_families_fixture():
    """What chip_smoke.py phase 19 checks on the card, here on the CPU:
    the prompt (80 tokens) wraps the 64-slot ring in prefill and decode."""
    z = np.load(LM_FAMILIES_FIXTURE)
    pc, pp, arrs = load_lm_family(z, NAME, "cpu")
    assert dataclasses.asdict(pc) == dataclasses.asdict(
        family_configs(NAME)[1])
    pr, n = arrs["prompts"], arrs["tokens"].shape[1]
    assert pr.shape[1] > pc.attn_window
    toks, first = serve_batch(pc, pp, pr, n, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), arrs["tokens"])
    np.testing.assert_array_equal(first.numpy(), arrs["first"])
    seq = np.concatenate([arrs["first"][:, None], arrs["tokens"]], 1)
    got = _port_prefill_and_decode(pc, pp, pr, seq, n)
    np.testing.assert_allclose(got[0], arrs["prefill_logits"], **LOGITS_TOL)
    np.testing.assert_allclose(np.stack(got[1:], 1), arrs["decode_logits"],
                               **LOGITS_TOL)
