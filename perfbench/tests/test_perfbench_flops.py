"""Operation and byte counts against hand counts at small shapes."""
from __future__ import annotations

import torch

from conftest import TINY
from yardstick import flops
from yardstick.peaks import least_seconds, peaks


def test_causal_pairs_match_a_mask():
    for T in (1, 2, 5, 64):
        mask = torch.ones(T, T).tril()
        assert flops.causal_pairs(T) == int(mask.sum())


def test_attention_counts_by_hand():
    # B 1, T 4, H 2, Hkv 1, D 8: 10 visible pairs a head
    ops, byts = flops.attn_fwd(1, 4, 2, 1, 8)
    assert ops == 2 * 2 * 8 * 10 * 2          # QK^T and PV, 2 per MAC
    # q 4x2x8, k 4x1x8, v 4x1x8, o 4x2x8 in bf16; lse 2x4 fp32
    assert byts == 2 * (64 + 32 + 32 + 64) + 4 * 8
    ops, byts = flops.attn_bwd(1, 4, 2, 1, 8)
    assert ops == 5 * 2 * 2 * 8 * 10
    # reads q, k, v, o, dO and lse; writes dq, dk, dv
    assert byts == 2 * (64 + 32 + 32 + 64 + 64) + 4 * 8 + 2 * (64 + 32 + 32)


def test_layer_params_by_hand():
    m = TINY   # d 64, 4 heads of 16, 2 kv heads, d_ff 96
    assert flops.layer_matmul_params(m) == (
        64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 96)


def test_step_counts_by_hand():
    m = TINY
    B, T = 2, 8
    n = 2 * flops.layer_matmul_params(m) + 64 * 512
    attn = 12 * 2 * B * 4 * 16 * (8 * 9 // 2)
    assert flops.train_step_flops(m, B, T) == 6 * n * B * T + attn
    pre = 2 * 2 * flops.layer_matmul_params(m) * T \
        + 4 * 2 * 4 * 16 * (8 * 9 // 2) + 2 * 64 * 512
    assert flops.prefill_flops(m, T) == pre


def test_attention_ops_match_the_reference_products():
    """The forward count equals the multiply-adds of masked QK^T and PV
    done densely over visible pairs only."""
    B, T, H, D = 1, 7, 3, 4
    vis = torch.ones(T, T).tril().sum()
    assert flops.attn_fwd(B, T, H, H, D)[0] == int(2 * 2 * H * D * vis)


def test_least_time_takes_the_larger_bound():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert least_seconds(989.4e12, 1.0, p) == 1.0
    assert least_seconds(1.0, 3.35e12, p) == 1.0
    assert peaks("a card not in the table") is None
