"""The benchmark's one door into the program under test (``repro_torch``):
its model configuration and its parameter tree, built from what the
harness made."""
from __future__ import annotations

from yardstick.model import Dense, program_leaves


def config(m: Dense):
    """The program's ``ModelConfig`` of the configuration file's model."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=m.name, family=m.family, n_layers=m.n_layers, d_model=m.d_model,
        n_heads=m.n_heads, n_kv_heads=m.n_kv_heads, d_ff=m.d_ff,
        vocab=m.vocab, head_dim=m.head_dim, qk_norm=m.qk_norm, rope="rope",
        rope_theta=float(m.rope_theta), norm_eps=float(m.norm_eps),
        tie_embeddings=m.tie_embeddings)


def param_tree(m: Dense, weights: dict):
    """The program's ``ParamTree`` whose leaves are the harness's weights
    (views, no copy); raises if a leaf's name or shape differs from the
    program's own tree."""
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.model import param_defs
    skeleton = ParamTree(param_defs(config(m)), device="meta")
    leaves = program_leaves(m, weights)
    want = {n: tuple(p.shape) for n, p in skeleton.named_parameters()}
    got = {n: tuple(t.shape) for n, t in leaves.items()}
    if want != got:
        raise ValueError(f"the program's parameter tree differs from the "
                         f"harness's: {sorted(set(want.items()) ^ set(got.items()))[:6]}")
    return skeleton.replaced(leaves)
