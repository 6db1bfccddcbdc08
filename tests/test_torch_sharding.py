"""PyTorch port, the sharding rules (``repro_torch.sharding``) and the
cell specs (``repro_torch.launch.specs``) against the JAX package's:
``choose_spec`` gives the reference's per-dim mesh axes for every leaf of
the ten configs' parameters under the default, FSDP and cell rules on the
(16, 16) and (2, 16, 16) meshes (the reference's stacked layer groups
drop their leading group dim, which no rule shards); ``cell_spec`` covers
all 32 valid cells, and every field of every decode state has axes.
Exact."""
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_arch as j_get_arch                 # noqa: E402
from repro.launch.specs import CELL_RULES as J_CELL              # noqa: E402
from repro.models import param_defs as j_param_defs              # noqa: E402
from repro.sharding.rules import DEFAULT_RULES as J_DEFAULT      # noqa: E402
from repro.sharding.rules import FSDP_RULES as J_FSDP            # noqa: E402
from repro.sharding.rules import choose_spec as j_choose_spec    # noqa: E402

import torch                                                     # noqa: E402
from torch.distributed.tensor import Replicate, Shard            # noqa: E402

from repro_torch.configs import all_archs, valid_cells           # noqa: E402
from repro_torch.launch import specs as S                        # noqa: E402
from repro_torch.models.model import init_cache, param_defs      # noqa: E402
from repro_torch.sharding import (DEFAULT_RULES, FSDP_RULES,     # noqa: E402
                                  NamedSharding, choose_spec, placements,
                                  spec_tree)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
RULES = [(DEFAULT_RULES, J_DEFAULT), (FSDP_RULES, J_FSDP),
         (S.CELL_RULES, J_CELL)]


def _leaves(tree, prefix=()):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _reference_leaf(jdefs, cfg, path):
    """The reference's ParamDef of the port's leaf ``path`` and whether it
    is stacked (a leading group dim)."""
    if path[0] != "layers":
        node = jdefs
        for k in path:
            node = node[k]
        return node, False
    i, rest = path[1], path[2:]
    P = len(cfg.block_pattern)
    G = cfg.n_groups()
    node = jdefs["groups"][f"b{i % P}"] if i < G * P else \
        jdefs["rem"][f"r{i - G * P}"]
    for k in rest:
        node = node[k]
    return node, i < G * P


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_choose_spec_matches_reference_on_every_leaf(arch):
    cfg = all_archs()[arch]
    jdefs = j_param_defs(j_get_arch(arch))
    n = 0
    tree = spec_tree(param_defs(cfg), MESHES[0], FSDP_RULES)
    for path, d in _leaves(param_defs(cfg)):
        node = tree
        for k in path:
            node = node[k]
        assert node == choose_spec(d.shape, d.logical_axes, MESHES[0],
                                   FSDP_RULES)
        jd, stacked = _reference_leaf(jdefs, cfg, path)
        assert tuple(jd.shape[stacked:]) == tuple(d.shape), path
        for mesh in MESHES:
            for rules, jrules in RULES:
                want = tuple(j_choose_spec(jd.shape, jd.logical_axes, mesh,
                                           jrules))[stacked:]
                got = choose_spec(d.shape, d.logical_axes, mesh, rules)
                assert got == want, (path, mesh.shape, got, want)
                n += 1
    assert n > 0


class _MeshNames:
    mesh_dim_names = ("data", "model")


def test_placements_follow_the_spec():
    m = _MeshNames()
    assert placements(("model", None), m) == (Replicate(), Shard(0))
    assert placements((None, ("model", "data")), m) == (Shard(1), Shard(1))
    assert placements(((), None), m) == (Replicate(), Replicate())
    assert NamedSharding(m, ("data", "model")).placements == (Shard(0),
                                                              Shard(1))


def test_cell_specs_cover_all_cells():
    """Every valid cell: one sharding per tensor, its spec as long as the
    tensor's rank (nothing allocated: meta tensors)."""
    mesh = MESHES[0]
    seen = set()
    for arch, shape in valid_cells():
        cs = S.cell_spec(arch, shape, mesh, device="meta")
        pairs = list(_pairs(cs.args_avals, cs.args_shardings))
        assert pairs, (arch, shape)
        for t, sh in pairs:
            assert isinstance(sh, NamedSharding), (arch, shape)
            assert len(sh.spec) == t.dim(), (arch, shape, sh, t.shape)
        seen.add((arch, shape))
    assert len(seen) == 32


def _pairs(tree, sh):
    from torch import nn
    if isinstance(tree, nn.Module):
        for n, p in tree.named_parameters():
            yield p, sh[n]
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], sh[k])
    elif isinstance(tree, (tuple, list)):
        for t, s in zip(tree, sh):
            yield from _pairs(t, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, sh


@pytest.mark.parametrize("kv_quant", [False, True])
def test_every_cache_field_has_axes(kv_quant):
    import dataclasses
    kinds = set()
    for cfg in all_archs().values():
        cfg = dataclasses.replace(cfg.reduced(), kv_quant=kv_quant)
        for st in init_cache(cfg, 2, 8, device="meta"):
            axes = S.state_axes(st)
            assert [len(a) for a in axes] == [t.dim() for t in st]
            kinds.add(type(st).__name__)
    assert kinds == ({"QuantAttnState"} if kv_quant else {"AttnState"}) | {
        "RGLRUState", "MLSTMState", "SLSTMState"}
