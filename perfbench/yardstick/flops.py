"""Operations and bytes from the shapes alone: the least work a call needs.

Operations count a multiply-add as 2.  Bytes count each input read once
and each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

from yardstick.model import Dense


def causal_pairs(T: int) -> int:
    """(query row, key column) pairs a causal mask leaves: row ``r`` sees
    columns ``0..r``."""
    return T * (T + 1) // 2


def attn_fwd(B: int, T: int, H: int, Hkv: int, D: int, elt: int = 2):
    """Causal attention forward: ``S = Q K^T`` and ``O = P V`` over the
    visible pairs; reads q, k, v, writes o and the rows' fp32
    log-sum-exp.  -> ``(operations, bytes)``."""
    ops = 4 * B * H * D * causal_pairs(T)
    byts = elt * B * T * D * (2 * H + 2 * Hkv) + 4 * B * H * T
    return ops, byts


def attn_bwd(B: int, T: int, H: int, Hkv: int, D: int, elt: int = 2):
    """Causal attention backward: the five products ``S = Q K^T``, ``dP =
    dO V^T``, ``dV = P^T dO``, ``dQ = dS K`` and ``dK = dS^T Q`` over the
    visible pairs; reads q, k, v, o, dO and the log-sum-exp, writes dq,
    dk, dv.  -> ``(operations, bytes)``."""
    ops = 10 * B * H * D * causal_pairs(T)
    byts = (elt * B * T * D * (3 * H + 2 * Hkv) + 4 * B * H * T
            + elt * B * T * D * (H + 2 * Hkv))
    return ops, byts


def layer_matmul_params(m: Dense) -> int:
    """Weights of one layer's products: q, k, v, o and the SwiGLU MLP."""
    d = m.d_model
    return d * m.d_q + 2 * d * m.d_kv + m.d_q * d + 3 * d * m.d_ff


def train_step_flops(m: Dense, B: int, T: int) -> int:
    """Model operations of one training step, recompute not counted: 6 per
    product weight and token (forward 2, backward 4; the layers and the
    vocabulary head) and the causal attention's forward and backward."""
    n = m.n_layers * layer_matmul_params(m) + m.d_model * m.vocab
    attn = 12 * m.n_layers * B * m.n_heads * m.head_dim * causal_pairs(T)
    return 6 * n * B * T + attn


def prefill_flops(m: Dense, T: int) -> int:
    """Model operations of one prompt's prefill: 2 per layer product weight
    and token, the causal attention's forward, and the head at the last
    position only."""
    layers = 2 * m.n_layers * layer_matmul_params(m) * T
    attn = 4 * m.n_layers * m.n_heads * m.head_dim * causal_pairs(T)
    return layers + attn + 2 * m.d_model * m.vocab
